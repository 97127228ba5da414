"""The one place that says which config switches the port carries.

The port keeps the JAX package's whole ``ModelConfig`` so both packages accept
the same presets, but it grows slice by slice. ``check_supported`` is called
when a grid or a ``Model`` is built and raises ``NotImplementedError`` naming
the roadmap item (ROADMAP.md, Queue 1 / Queue 2) for every switch whose
physics is not ported yet — nothing falls through to a different scheme.
"""

from __future__ import annotations

from pop2_tpu_torch.config import ModelConfig


def unsupported(cfg: ModelConfig) -> list:
    """Reasons ``cfg`` cannot run on this slice of the port (empty = ok)."""
    t = cfg.time
    checks = [
        (cfg.horiz_grid != "internal" or cfg.topography != "internal"
         or cfg.vert_grid not in ("internal", "uniform"),
         "grid/topography 'file' readers (Queue 1 item 11: io/grid_files)"),
        (cfg.ew_boundary not in ("cyclic", "closed"),
         f"ew_boundary={cfg.ew_boundary!r}"),
        ("abio_dic" in cfg.passive_tracers,
         "passive tracer package 'abio_dic' (Queue 1 item 11: abio_dic.py "
         "and co2calc.py beside passive_tracers.py)"),
        ("ecosys" in cfg.passive_tracers,
         "passive tracer package 'ecosys' (Queue 1 item 11: ecosys.py "
         "beside passive_tracers.py)"),
        (cfg.state_choice not in ("mwjf", "jmcd", "linear", "polynomial"),
         f"state_choice={cfg.state_choice!r}"),
        (cfg.state_choice == "polynomial" and bool(cfg.overflows),
         "overflows under state_choice='polynomial' (their densities are "
         "taken at the overflow regions' own pressures, which have no "
         "polynomial fit; the JAX package fails there too)"),
        (cfg.ns_boundary not in ("closed", "tripole"),
         f"ns_boundary={cfg.ns_boundary!r}"),
        (cfg.tadvect not in ("centered", "upwind3", "lw_lim"),
         f"tadvect={cfg.tadvect!r}"),
        (cfg.hmix_tracer not in ("del2", "gm", "del4"),
         f"hmix_tracer={cfg.hmix_tracer!r}"),
        (cfg.hmix_momentum not in ("del2", "aniso", "del4"),
         f"hmix_momentum={cfg.hmix_momentum!r}"),
        (cfg.vmix not in ("const", "rich", "kpp"),
         f"vmix={cfg.vmix!r}"),
        (not cfg.implicit_vertical_mix,
         "explicit vertical mixing (absent from the JAX package too)"),
        (cfg.sw_absorption == "chlorophyll" and cfg.chl_option == "model",
         "chl_option='model' (Queue 1 item 11: chlorophyll of the ecosystem "
         "model, ecosys.py)"),
        (cfg.sw_absorption == "chlorophyll"
         and cfg.chl_option not in ("const", "file", "model"),
         f"chl_option={cfg.chl_option!r}"),
        (cfg.ltidal_mixing and cfg.tidal_mixing_method not in (
            "jayne", "polzin", "schmittner"),
         f"tidal_mixing_method={cfg.tidal_mixing_method!r}"),
        (t.time_mix_opt not in ("avg", "avgfit", "robert"),
         f"time_mix_opt={t.time_mix_opt!r}"),
        (cfg.solver.preconditioner.lower() not in ("diagonal", "fspai"),
         f"preconditioner={cfg.solver.preconditioner!r} (Queue 1 item 11: "
         "spai / file)"),
        (cfg.solver.choice.lower() not in ("chrongear", "pcg", "pcsi"),
         f"solver choice {cfg.solver.choice!r}"),
        (cfg.b4b, "b4b reproducible sums (Queue 1 item 12)"),
        (tuple(cfg.mesh_shape) != (1, 1),
         "mesh_shape != (1, 1) (Queue 1 item 12: multi-GPU)"),
    ]
    if cfg.hmix_tracer == "gm":
        checks += _gm_checks(cfg)
    return [why for bad, why in checks if bad]


def _gm_checks(cfg: ModelConfig) -> list:
    """What of GM the port carries: every diffusivity type of the JAX
    package, in any isopycnal/thickness pair, under any equation of state,
    isotropic or anisotropic ('grid', 'flow'; with the transition layer
    ``gm.hdifft_gm`` raises, as the JAX package's does), full or partial
    bottom cells, a closed or tripole north edge."""
    kinds = (cfg.gm_kappa_isop_type, cfg.gm_kappa_thic_type)
    known = ("const", "depth", "bfre", "vmhs", "eg")
    return [
        (cfg.gm_aniso not in (None, "grid", "flow"),
         f"gm_aniso={cfg.gm_aniso!r} (the JAX package carries 'grid' and "
         "'flow')"),
        (any(k not in known for k in kinds),
         f"gm kappa types {kinds!r} (the JAX package carries {known!r})"),
    ]


def check_supported(cfg: ModelConfig) -> None:
    why = unsupported(cfg)
    if why:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(why))
