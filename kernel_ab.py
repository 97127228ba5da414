#!/usr/bin/env python3
"""Time this checkout's kernels beside another checkout's, in turns, on one
GPU: the tool for judging a kernel's redesign against the design it
replaces.

    mkdir -p _parent && git archive <commit> pop2_tpu_torch | tar -x -C _parent
    python3 kernel_ab.py _parent [GROUP]

(``_parent/`` is git-ignored; GROUP, a word of the case groups' names
``tracer_clinic``, ``tracer_fold``, ``thomas``, ``gm``, runs those alone.)
Both checkouts are driven through their wrappers
(``tridiag_cuda.thomas``, ``tracer_cuda.tracer_tendency``,
``clinic_cuda.clinic_rhs_fields``, ``gm_slope_cuda.slopes``,
``gm_chain_cuda.chain``, ``gm_cuda.flux_assembly``), whose interface a
redesign keeps: the other checkout's package is imported from its own
directory, apart from this one's, and builds its kernels from its own
sources. The operands are those of ``chip_smoke.py``'s kernel phases at
320 x 384 x 60, nt = 2, in float32 and float64: thomas for 1 and 2
right-hand sides, the tracer tendency with the Laplacian (the core path's
mode) and without it (the GM paths'), and on the tripole fold (a bottom
with ocean across it, the top U row's DXU opened) with upwind3 advection
for two tracers (the prod_dyn path's launch) and one (prod_full's group of
one) and with centered advection, the momentum forcing on a leapfrog
step, the slopes of the gm_full path's stratified tracers, the chain kernel
in the gm_full path's instance and in the prod_dyn path's (the tripole
fold, on a bottom with ocean across it), the flux assembly in both of its
instances (the gm_flux path's cancellation and the skew) and in both on
the tripole fold for prod_full's five tracers (the prod_flux path's
launch; the top row's north faces opened). Each kernel runs in turns
other, this, this, other; a turn takes both of ``chip_smoke.py``'s times:
``ms`` (median of single calls between CUDA events, the ``kernels`` line's
method) and ``ms_back_to_back`` (calls back to back). The two checkouts'
outputs are compared: the largest difference over the output's largest
value, and whether they are bitwise equal.

Prints the card's name and power limit, then one JSON object a line.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import clinic_cuda, gm, gm_chain_cuda, gm_cuda
from pop2_tpu_torch import gm_slope_cuda, pgrad, sample, tracer_cuda
from pop2_tpu_torch import tridiag_cuda
from pop2_tpu_torch.grid import build_grid, grid_bc

PKG = "pop2_tpu_torch"
N = 20  # calls a turn, for each of the two times


def _ours() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def other_package(root: Path) -> dict:
    """The other checkout's wrapper modules and build module, imported from
    ``root`` under the package's own name and then set apart, so that this
    checkout's modules stay what ``import`` finds."""
    ours = _ours()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        mods = {n: importlib.import_module(f"{PKG}.{n}")
                for n in ("_cuda_build", "tridiag_cuda", "tracer_cuda",
                          "clinic_cuda", "gm_slope_cuda", "gm_chain_cuda",
                          "gm_cuda")}
    finally:
        sys.path.remove(str(root))
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(ours)
    where = Path(mods["_cuda_build"].__file__).resolve()
    if root not in where.parents:
        raise SystemExit(f"{root}: no {PKG} package there ({where})")
    return mods


def in_turns(other, this) -> dict:
    """Both times of each, in turns other, this, this, other."""
    rec = {"ms_other": [], "ms_this": [], "ms_back_to_back_other": [],
           "ms_back_to_back_this": []}
    for name, fn in (("other", other), ("this", this), ("this", this),
                     ("other", other)):
        rec["ms_" + name].append(cs.time_ms(fn, 3, N))
        rec["ms_back_to_back_" + name].append(
            cs.time_ms_back_to_back(fn, N))
    for key in ("ms", "ms_back_to_back"):
        rec[key + "_this_over_other"] = (sum(rec[key + "_this"])
                                         / sum(rec[key + "_other"]))
    return rec


def rel_diff(got, want) -> float:
    """Largest difference between two checkouts' outputs over the largest
    value, across the outputs."""
    return max(float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
               for a, b in zip(got, want))


def bitwise(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def tracer_clinic_cases(other, dtype_name):
    """The tracer tendency in both modes and the momentum forcing, with the
    operands and aliasing of ``chip_smoke.kernel_phase``."""
    for path, seed in (("core", cs.SEED), ("gm_full", cs.SEED + 3)):
        cfg = cs.full_config(dtype_name, path)
        # each checkout's wrappers keep their per-grid tables on the grid
        grid, grid_o = build_grid(cfg, cs.DEV), build_grid(cfg, cs.DEV)
        gen = torch.Generator(device=cs.DEV)
        gen.manual_seed(seed)
        f = cs.random_fields(cfg, grid, gen)
        ops = (f["ucur"], f["vcur"], f["trcr"], f["told"], f["told"],
               f["vdc"], f["stf"], f["dh"])
        mine = lambda: tracer_cuda.tracer_tendency(cfg, grid, *ops)
        theirs = lambda: other["tracer_cuda"].tracer_tendency(cfg, grid_o,
                                                              *ops)
        rec = in_turns(theirs, mine)
        rec["rel_diff_this_vs_other"] = rel_diff([mine()], [theirs()])
        rec["bitwise_equal"] = bitwise([mine()], [theirs()])
        cs.emit({"kernel": "tracer", "dtype": dtype_name,
                 "mode": "del2" if path == "core" else "no_del2", **rec})
        if path != "core":
            continue
        rhoavg = pgrad.rho_average(cfg, grid, f["rho"][0], f["rho"][1],
                                   f["rho"][2], True)
        wc, wo = clinic_cuda.coriolis_weights(cfg, True)
        ops = (f["ucur"], f["vcur"], f["uold"], f["vold"], f["uold"],
               f["vold"], rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
        mine = lambda: clinic_cuda.clinic_rhs_fields(cfg, grid, *ops)
        theirs = lambda: other["clinic_cuda"].clinic_rhs_fields(cfg, grid_o,
                                                                *ops)
        rec = in_turns(theirs, mine)
        rec["rel_diff_this_vs_other"] = rel_diff(mine(), theirs())
        rec["bitwise_equal"] = bitwise(mine(), theirs())
        cs.emit({"kernel": "clinic", "dtype": dtype_name, **rec})


def tracer_fold_cases(other, dtype_name):
    """The tracer tendency on the tripole fold, without the Laplacian: the
    prod_dyn path's upwind3 launch (nt = 2), prod_full's group of one, and
    centered advection, with the operands of ``chip_smoke.fold_kernel_phase``
    on ``chip_smoke.fold_case``'s bottom with the top U row's DXU opened."""
    cfg = cs.full_config(dtype_name, "prod_dyn")
    # each checkout's wrappers keep their per-grid tables on the grid
    grid = sample.open_top_dxu(cs.fold_case(cfg)[0])
    grid_o = sample.open_top_dxu(cs.fold_case(cfg)[0])
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED + 12)
    f = cs.random_fields(cfg, grid, gen)
    for adv, nt in (("upwind3", 2), ("upwind3", 1), ("centered", 2)):
        c = cfg.with_(tadvect=adv)
        ops = (f["ucur"], f["vcur"], f["trcr"][:nt], f["told"][:nt],
               f["told"][:nt], f["vdc"], f["stf"][:nt], f["dh"])
        mine = lambda: tracer_cuda.tracer_tendency(c, grid, *ops)
        theirs = lambda: other["tracer_cuda"].tracer_tendency(c, grid_o,
                                                              *ops)
        rec = in_turns(theirs, mine)
        rec["rel_diff_this_vs_other"] = rel_diff([mine()], [theirs()])
        rec["bitwise_equal"] = bitwise([mine()], [theirs()])
        cs.emit({"kernel": "tracer", "dtype": dtype_name,
                 "mode": f"{adv}_tripole_no_del2", "nt": nt, **rec})


def thomas_cases(other, dtype_name):
    cfg = cs.full_config(dtype_name)
    grid = build_grid(cfg, cs.DEV)
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    f = cs.random_fields(cfg, grid, gen)
    hfac, h1, a = cs.thomas_operands(cfg, grid, f)
    for nr in (1, 2):
        args = (hfac, h1, grid.KMT, a, f["rhs"][:nr].contiguous())
        rec = in_turns(lambda: other["tridiag_cuda"].thomas(*args),
                       lambda: tridiag_cuda.thomas(*args))
        mine = [tridiag_cuda.thomas(*args)]
        theirs = [other["tridiag_cuda"].thomas(*args)]
        rec["rel_diff_this_vs_other"] = rel_diff(mine, theirs)
        rec["bitwise_equal"] = bitwise(mine, theirs)
        cs.emit({"kernel": "thomas", "dtype": dtype_name, "nr": nr, **rec})


def gm_cases(other, dtype_name):
    cfg = cs.full_config(dtype_name, "gm_full")
    # each checkout's wrappers keep their per-grid tables on the grid object
    grid, grid_o = build_grid(cfg, cs.DEV), build_grid(cfg, cs.DEV)
    bc = grid_bc(cfg)
    tr = cs.ts_range_of(cfg, grid)
    tmix = sample.grid_tracers(cfg, grid, cs.SEED + 2)
    ops = (bc, tr, tmix)
    rec = in_turns(
        lambda: other["gm_slope_cuda"].slopes(cfg, grid_o, *ops),
        lambda: gm_slope_cuda.slopes(cfg, grid, *ops))
    mine = gm_slope_cuda.slopes(cfg, grid, *ops)
    theirs = other["gm_slope_cuda"].slopes(cfg, grid_o, *ops)
    # slopes divided by the clamp are ~1e13: compare N^2 and the measure,
    # and count the slopes that differ at all
    rec["rel_diff_this_vs_other"] = rel_diff(mine[1:], theirs[1:])
    rec["slopes_differing"] = int((mine[0] != theirs[0]).sum())
    rec["bitwise_equal"] = bitwise(mine, theirs)
    cs.emit({"kernel": "gm_slope", "dtype": dtype_name, **rec})
    del mine, theirs
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, tr, tmix)
    tlt = gm.transition_layer(cfg, grid, gm.first_layer_depth(grid), sla,
                              gm._rossby_radius(grid))
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    ops = (tmix, slp, sla, kv, tlt, False)
    rec = in_turns(
        lambda: other["gm_chain_cuda"].chain(cfg, grid_o, bc, *ops),
        lambda: gm_chain_cuda.chain(cfg, grid, bc, *ops))
    mine = gm_chain_cuda.chain(cfg, grid, bc, *ops)[:2]
    theirs = other["gm_chain_cuda"].chain(cfg, grid_o, bc, *ops)[:2]
    rec["rel_diff_this_vs_other"] = rel_diff(mine, theirs)
    rec["bitwise_equal"] = bitwise(mine, theirs)
    cs.emit({"kernel": "gm_chain", "dtype": dtype_name, **rec})
    del slp, sla, n2, kv, tlt, ops
    chain_fold_case(other, dtype_name)

    cfg_f = cs.full_config(dtype_name, "gm_flux")
    f = sample.flux_operands(cfg_f, grid, bc, tr, tmix)
    for cancellation in (True, False):
        ops = f + (cancellation,)
        rec = in_turns(
            lambda: other["gm_cuda"].flux_assembly(cfg_f, grid_o, bc, *ops),
            lambda: gm_cuda.flux_assembly(cfg_f, grid, bc, *ops))
        mine = gm_cuda.flux_assembly(cfg_f, grid, bc, *ops)
        theirs = other["gm_cuda"].flux_assembly(cfg_f, grid_o, bc, *ops)
        rec["rel_diff_this_vs_other"] = rel_diff(mine, theirs)
        rec["bitwise_equal"] = bitwise(mine, theirs)
        cs.emit({"kernel": "gm_flux", "dtype": dtype_name,
                 "instance": "cancellation" if cancellation else "skew",
                 **rec})
    flux_fold_case(other, dtype_name)


def flux_fold_case(other, dtype_name):
    """The flux assembly's tripole row for five tracers (the prod_flux
    path's launch, a tile of the narrow rows), both branches, on
    ``chip_smoke.fold_case``'s bottom with the top row's north faces
    opened, as ``chip_smoke.flux_fold_phase`` holds it."""
    cfg = cs.full_config(dtype_name, "prod_flux")
    grid, bc, tr = cs.fold_case(cfg)
    grid = sample.open_top_face(grid)
    grid_o = sample.open_top_face(cs.fold_case(cfg)[0])
    tmix = sample.grid_tracers(cfg, grid, cs.SEED + 20)
    f = sample.flux_operands(cfg, grid, bc, tr, tmix)
    for cancellation in (True, False):
        ops = f + (cancellation,)
        rec = in_turns(
            lambda: other["gm_cuda"].flux_assembly(cfg, grid_o, bc, *ops),
            lambda: gm_cuda.flux_assembly(cfg, grid, bc, *ops))
        mine = gm_cuda.flux_assembly(cfg, grid, bc, *ops)
        theirs = other["gm_cuda"].flux_assembly(cfg, grid_o, bc, *ops)
        rec["rel_diff_this_vs_other"] = rel_diff(mine, theirs)
        rec["bitwise_equal"] = bitwise(mine, theirs)
        cs.emit({"kernel": "gm_flux", "dtype": dtype_name, "nt": cfg.nt,
                 "instance": ("tripole_cancellation" if cancellation
                              else "tripole_skew"), **rec})


def chain_fold_case(other, dtype_name):
    """The chain kernel in the prod_dyn path's instance: the tripole fold,
    on ``chip_smoke.fold_case``'s bottom with ocean across it."""
    cfg = cs.full_config(dtype_name, "prod_dyn")
    grid, bc, tr = cs.fold_case(cfg)
    grid_o = cs.fold_case(cfg)[0]
    tmix = sample.grid_tracers(cfg, grid, cs.SEED + 13)
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, tr, tmix)
    tlt = gm.transition_layer(cfg, grid, gm.first_layer_depth(grid), sla,
                              gm._rossby_radius(grid))
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    ops = (tmix, slp, sla, kv, tlt, False)
    rec = in_turns(
        lambda: other["gm_chain_cuda"].chain(cfg, grid_o, bc, *ops),
        lambda: gm_chain_cuda.chain(cfg, grid, bc, *ops))
    mine = gm_chain_cuda.chain(cfg, grid, bc, *ops)[:2]
    theirs = other["gm_chain_cuda"].chain(cfg, grid_o, bc, *ops)[:2]
    rec["rel_diff_this_vs_other"] = rel_diff(mine, theirs)
    rec["bitwise_equal"] = bitwise(mine, theirs)
    cs.emit({"kernel": "gm_chain", "instance": "tripole",
             "dtype": dtype_name, **rec})


def main():
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    groups = [g for g in (tracer_clinic_cases, tracer_fold_cases,
                          thomas_cases, gm_cases)
              if len(sys.argv) == 2 or sys.argv[2] in g.__name__]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = other_package(Path(sys.argv[1]).resolve())
    ocb = other["_cuda_build"]
    ocb.lib()
    cb.lib()
    cs.emit({"build_seconds_other": ocb.build_seconds,
             "build_seconds_this": cb.build_seconds,
             "ptxas_other": cs.ptxas_summary(ocb.build_log()),
             "ptxas_this": cs.ptxas_summary()})
    for dtype_name in ("float32", "float64"):
        for cases in groups:
            cases(other, dtype_name)


if __name__ == "__main__":
    main()
