"""The production configuration, as the JAX package assembles it.

``get_config('prod_full')`` carries the IO-free part of the reference's
gx1v7 default physics menu (bld/namelist_files/namelist_defaults_pop.xml).
Where the caller names a directory of the reference's input templates
(``input_templates/``), ``get_production_config`` attaches what the JAX
package's does from it, read by the port's own parsers
(``io/input_templates.py``): the real 60-level vertical grid
(``gx1v7_vert_grid``) and the real overflow geometry (``gx1v7_overflow``:
Denmark Strait, Faroe Bank Channel, Ross Sea and Weddell Sea, with kmt
pop-ups, region boxes and sidewall orientations). Without one it returns
the preset, as the JAX package does where that directory is absent; the
port looks for no directory of its own.
"""

from __future__ import annotations

import os

from pop2_tpu_torch.config import ModelConfig, get_config


def get_production_config(name: str = "prod_full",
                          templates: str | None = None,
                          **overrides) -> ModelConfig:
    """The flagship configuration: the preset ``name``, with the file
    vertical grid and the overflow geometry of ``templates`` where that
    directory holds them (at the gx1v7 dimensions), then ``overrides``."""
    cfg = get_config(name)
    if templates is not None and os.path.isdir(templates):
        from pop2_tpu_torch.io import input_templates as it
        vg = os.path.join(templates, "gx1v7_vert_grid")
        if cfg.km == 60 and os.path.exists(vg):
            cfg = cfg.with_(vert_grid="file", vert_grid_file=vg)
        ovf = os.path.join(templates, "gx1v7_overflow")
        if (cfg.nx, cfg.ny) == (320, 384) and os.path.exists(ovf):
            cfg = cfg.with_(overflows=it.read_overflows(ovf))
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg
