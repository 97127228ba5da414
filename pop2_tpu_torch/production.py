"""The production configuration, as the JAX package assembles it.

``get_config('prod_full')`` carries the IO-free part of the reference's
gx1v7 default physics menu (bld/namelist_files/namelist_defaults_pop.xml).
The JAX package's ``production.get_production_config`` attaches the pieces
that come from the reference's input files when its ``input_templates``
directory is there: the real overflow geometry (``gx1v7_overflow``) and the
real 60-level vertical grid (``gx1v7_vert_grid``). The port has no readers
for those files yet (ROADMAP.md Queue 1 item 11), so it returns the preset,
as the JAX package does where that directory is absent, and raises where the
caller names a templates directory rather than return a config that differs
from the JAX package's. It looks for no directory of its own.
"""

from __future__ import annotations

import os

from pop2_tpu_torch.config import ModelConfig, get_config


def get_production_config(name: str = "prod_full",
                          templates: str | None = None,
                          **overrides) -> ModelConfig:
    """The flagship configuration: the preset ``name`` with ``overrides``.
    Raises ``NotImplementedError`` where ``templates`` is a directory: the
    JAX package would read the file vertical grid and the overflow
    geometry there, which the port cannot yet."""
    if templates is not None and os.path.isdir(templates):
        raise NotImplementedError(
            f"{templates} holds the reference's input templates: the file "
            "vertical grid and the overflow geometry (read_overflows) that "
            "the JAX package attaches from it are not ported yet (ROADMAP.md "
            "Queue 1 item 11)")
    cfg = get_config(name)
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg
