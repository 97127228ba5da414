#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (pop2_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version at the shapes the main paths
give it (320 x 384 x 60, the production gx1v7 dimensions, nt = 2) in float32
and float64, times both (and reports each kernel's block, shared memory and
blocks an SM holds), holds every kernel against its plain version on a
grid its tile does not divide, and drives the
port's nineteen paths through ``Model.advance`` (Euler step, leapfrog steps,
averaging or Robert-filtered steps) at that size in float32 and in float64
(gm_pbc in float32 alone):

    core      the dynamical core (Laplacian tracer mixing)
    gm_full   GM/Redi mixing with the transition layer and bfre
              diffusivities: slope kernel -> plain searches -> chain kernel
              -> tracer kernel without the Laplacian
    gm_flux   GM/Redi mixing without the transition layer, constant
              diffusivities: plain chain -> flux-assembly kernel
    prod_dyn  the production gx1v7 dynamics menu: tripole north edge,
              upwind3 advection (the tracer kernel's two-column frame),
              anisotropic viscosity (the momentum kernel without the
              Laplacian), GM as gm_full, chlorophyll shortwave, frazil ice,
              the Robert filter, PCSI with the FSPAI preconditioner
    prod_mix  the production gx1v7 menu less its passive tracers: prod_dyn
              with KPP (plain) and Jayne tidal mixing; GM's transition layer
              starts at KPP's boundary layer (the search kernel) and the
              chain kernel folds in the submesoscale streamfunction
    prod_full the whole production configuration,
              ``production.get_production_config()``: prod_mix with the
              ideal age and the CFC tracers (nt = 5) under a 10-m wind,
              thomas for up to four right-hand sides, the tracer kernel in
              three launches a step
    prod_flux prod_full without GM's transition layer: plain chain ->
              the flux-assembly kernel on the tripole grid
    prod_vmix prod_full with the rest of vertical mixing: Polzin tidal
              mixing under the lunar cycle, near-inertial wave mixing from
              the boundary-layer energy, geothermal heat and depth
              acceleration below 1000 m (thomas takes the per-level step)
    prod_hmix the biharmonic menu of the eddy-resolving preset on the
              gx1v7 shape: del4 tracer mixing beside the tracer kernel
              without the Laplacian, del4 momentum mixing beside the
              momentum kernel without the friction, Schmittner tidal
              mixing with the Southern-Ocean floor, velocity damping
    core_topo core with topographic stress: the momentum kernel's fused
              friction acts on u - TSU
    prod_eg   prod_full with Eden-Greatbatch diffusivities: GM through
              ``gm.hdifft_gm`` (plain slopes, the search kernel, the plain
              eg diffusivity, the flux-assembly kernel's skew tripole row),
              the submesoscale tendency on its own
    prod_aniso prod_full without the transition layer, with Visbeck
              diffusivities and flow-aligned anisotropic GM: the
              flux-assembly kernel's anisotropic (ANISO) tripole row
    core_lw   core with the flux-limited Lax-Wendroff advection (plain,
              with the plain vertical diffusion: the tracer kernel is not
              launched), the polynomial equation of state, and GM under it
              with the depth profile and differing diffusivity types (the
              flux-assembly kernel's skew branch)
    prod_pbc  prod_hmix under partial bottom cells, the tx0.1v3 preset's
              menu on the gx1v7 shape: the thomas, tracer (upwind3) and
              momentum kernels' PBC instances read the bottom level's
              thickness (a bottom-cell file written from a seed)
    gm_pbc    the production configuration under partial bottom cells: GM's
              kernels on the 1-D dz (as the JAX package's), the PBC
              instances of thomas (nr up to 4), tracer and momentum
    prod_forced the production configuration forced as an ocean-only run:
              each step's forcing composed from the state (``ForcedForcing``:
              a monthly wind-stress file, bulk-NCEP heat and freshwater
              fluxes from seeded monthly climatologies, a balanced marginal
              sea, river runoff), the chlorophyll of the forcing, the
              estuary box model's exchange, interior T/S restoring; the
              kernels of prod_full
    prod_bgc  the production configuration with CESM's ocean
              biogeochemistry: the 32-tracer ecosystem and the abiotic
              DIC/DIC14 beside the age and the CFCs (nt = 39), the
              ecosystem's own chlorophyll in the shortwave absorption; the
              GM chain kernel in groups of tracers (five launches a step in
              float32, three in float64), the tracer kernel twenty
              times, thomas in groups of up to four right-hand sides
    prod_file the production configuration on a gx-class grid read from
              POP-format files (``gridgen.generate_gx_files`` at
              320x384x60: latitude spacing refined at the equator, ANGLE
              from the file, an earthlike KMT with 3-level shelves beside
              columns at km): the kernels and launch counts of prod_full
    gx3v7     the JAX package's gx3v7 preset on generated files at
              100x116x60 with a closed north edge: KPP, GM with constant
              diffusivities (plain chain -> the flux-assembly kernel), the
              momentum kernel without the Laplacian, the tracer kernel
              centered without the Laplacian, ChronGear solving in float64

On every GM path with the transition layer the search runs as a kernel.
The modes of the tracer, momentum, slope and chain kernels that the tripole
paths add are also held against their plain versions on a bottom with
ocean across the tripole fold (the internal grid's top rows are land,
which would hide the fold); the chain (with prod_full's five tracers too)
and the flux assembly's tripole row (isotropic and anisotropic) are held
there with the top row's north faces opened (``sample.open_top_face``: the
internal grid's top row lies on the pole, where no north-face flux crosses
the fold), the tracer kernel with the top U row's DXU opened
(``sample.open_top_dxu``).
An overflow phase runs the 'mini' preset with the overflows of the JAX
package's tests on the card against the same on the CPU.
The ``cpl`` phase runs prod_file's float32 configuration under the coupler
cap (``OcnComponent``, three steps a coupling interval): initialize, two
intervals of seeded SI import fields (the first ending in a restart written
on request), a second component resumed from that restart whose second
interval's export must equal the first's bitwise, every export field inside
its physical range, the launches an interval, and the same interval on a
small file grid in float64 on the GPU against the CPU. The ``spai`` phase
runs core's configuration with the 9-point SPAI preconditioner and with the
same stencil read back from an .npz ('file'), which must agree bitwise, and
reports the host build, the iterations against the diagonal run and PCSI's
bounds under the stencil.

For each path it checks through the wrappers' launch counters (zeroed just
before, read just after) that the steps really went through the kernels.
On core, gm_full, prod_full, prod_vmix, prod_hmix, core_topo, prod_eg,
prod_aniso, core_lw, prod_pbc, prod_forced, prod_bgc and prod_file runs
``Model.run_compiled`` (CUDA graphs of the step's segments) against
``Model.run`` from one state (``run_loop`` phase): every state leaf bitwise
equal (or inside the eager-against-eager spread), iterations and launch
counts equal, graphs replayed, no host read but the solver's convergence
checks, a restart round trip on prod_full, and on prod_vmix the lunar
factor in the captured step's static forcing buffer equal to the
calendar's at every step across a jump of the calendar by years, and on
prod_forced two steps under a forcing without two of its fields build a
new captured step, bitwise equal to ``advance``. The plain
parts the last three paths add (Polzin, NIW, del4, the TSU subtraction)
are timed at full size (``menu_parts_phase``). It
compares a step with the kernels against a step with the plain versions
(and, in float32 on core, gm_full, prod_full and prod_bgc, both against
the float64 run) on the core, gm_full,
prod_dyn, prod_mix, prod_full, prod_vmix, prod_hmix, core_topo, prod_eg,
prod_aniso, core_lw, prod_pbc, gm_pbc, prod_forced, prod_bgc, prod_file
and gx3v7 paths,
holds every ported forcing function on the card against the CPU in float64
and times the build of a step's forcing (``forcing_phase``),
holds the partial-bottom-cell (PBC) instances of thomas, the tracer and the
momentum kernels against their plain versions on stepped bottoms whose
every column ends in a partial cell (``pbc_kernel_phase``), breaks
prod_full's step time down by part and by device kernel (from a
stratified state with slopes for GM to work on), compares the GPU path
with the CPU path on a small grid, and runs prod_full decomposed over
ranks of the card (``ranks_phase``: y slabs of 192 rows and (2, 2)
blocks, gloo, b4b sums, against the whole domain: float64 through
``advance``, float32 through ``run_compiled`` with a tavg stream of every
field, its file bytewise the whole domain's; each stencil kernel halo'd
on its block; on (2, 2) the ecosystem, the coupler cap and the overflows
at a small size), then the same prod_full on a (2, 2) mesh in this one
process (``local_mesh_phase``: a thread a block, the exchanges device
copies, float64 through ``advance`` and float32 through ``run_compiled``
captured in CUDA graphs that hold every block, held against the same
whole-domain runs bitwise; each stencil kernel halo'd on every block; the
captured step's ms and busy share beside the gloo ranks' figures). Every
phase that fails makes the script exit non-zero;
with no
GPU it exits at once without a result. It takes no arguments: every run
is the whole check.

Output: one JSON object per line; the ``kernels`` line, then the card's name
and power limit, then the final ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import inspect
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import weakref

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; this script measures on "
                     "the GPU only\n")
    sys.exit(2)

from pop2_tpu_torch import _cuda_build as cb  # noqa: E402
from pop2_tpu_torch import baroclinic, clinic_cuda, gm, gm_chain_cuda  # noqa: E402
from pop2_tpu_torch import eos, gm_cuda, gm_slope_cuda, gm_tlt_cuda  # noqa: E402
from pop2_tpu_torch import kpp, overflows, production, submeso  # noqa: E402
from pop2_tpu_torch import tracer_cuda, tridiag, tridiag_cuda  # noqa: E402
from pop2_tpu_torch import constants as const  # noqa: E402
from pop2_tpu_torch import hmix, pgrad, sample, solvers  # noqa: E402
from pop2_tpu_torch import co2calc, ecosys, tidal_mixing  # noqa: E402
from pop2_tpu_torch import estuary, forcing as forcing_mod  # noqa: E402
from pop2_tpu_torch import forcing_sfwf, forcing_shf  # noqa: E402
from pop2_tpu_torch import forcing_tools, mcog, ms_balance  # noqa: E402
from pop2_tpu_torch import running_mean, samplers  # noqa: E402
from pop2_tpu_torch import coupled, gridgen  # noqa: E402
from pop2_tpu_torch.barotropic import diagonal_correction  # noqa: E402
from pop2_tpu_torch.config import (OverflowSpec, RegionBox,  # noqa: E402
                                   SolverConfig, get_config)
from pop2_tpu_torch.grid import (bottom_cells, bottom_planes,  # noqa: E402
                                 build_grid, build_topostress, grid_bc,
                                 partial_bottom_cells, vertical_dz)
from pop2_tpu_torch.model import Model  # noqa: E402
from pop2_tpu_torch.ocn_component import OcnComponent  # noqa: E402
from pop2_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pop2_tpu_torch.parallel import multihost  # noqa: E402
from pop2_tpu_torch.state import initial_state  # noqa: E402

DEV = torch.device("cuda")
SEED = 20240613
# eager steps per path and dtype: an Euler step and leapfrog steps (cut for
# the script's time limit; the averaging step runs in run_loop_phase's core
# and gm_full runs, at step 17)
STEPS = {path: {"float32": 3, "float64": 2}
         for path in ("core", "gm_full", "gm_flux", "prod_dyn", "prod_mix",
                      "prod_full", "prod_flux", "prod_vmix", "prod_hmix",
                      "core_topo", "prod_eg", "prod_aniso", "core_lw",
                      "prod_pbc", "gm_pbc", "prod_forced", "prod_file",
                      "gx3v7", "prod_bgc")}
del STEPS["gm_pbc"]["float64"]
N_TIMED = 20     # timed launches per kernel, after warm-up
# a horizontal size that no tile of the kernels divides (nx, ny), and the
# level counts held there: one level, and the kernels' bound of 64
RAGGED = (37, 53)
RAGGED_KM = (1, 61, 64)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): device memory rate and
# the non-tensor-core arithmetic rates the kernels can use
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# kernel-vs-plain bands: float32 as the fractions of the field's scale the
# JAX package holds its TPU kernels to; float64 relative to the scale
BAND = {
    ("thomas", torch.float32): 2e-5, ("tracer", torch.float32): 2e-5,
    ("clinic", torch.float32): 4e-5,
    ("thomas", torch.float64): 1e-12, ("tracer", torch.float64): 1e-12,
    ("clinic", torch.float64): 1e-12,
    ("tracer_advdiff", torch.float32): 2e-5,
    ("tracer_advdiff", torch.float64): 1e-12,
    # flux assembly: GTK by scale; VDC_GM is held point by point (GM_VDC_RTOL)
    ("gm_flux", torch.float32): 2e-5, ("gm_flux", torch.float64): 1e-12,
    # chain: float32 within 5e-5 of scale or 5e-2 of the value (points riding
    # the clamped-slope cancellation carry a local relative spread)
    ("gm_chain", torch.float32): 5e-5, ("gm_chain", torch.float64): 1e-12,
    # transition-layer search: K_LEVEL and ZTW equal; the thickness and the
    # interior depth are differences of the same operands as in the plain
    # version (expected bitwise), held at rounding of scale
    ("gm_tlt", torch.float32): 1e-6, ("gm_tlt", torch.float64): 1e-12,
}
GM_CHAIN_REL = {torch.float32: 5e-2, torch.float64: 0.0}
GM_VDC_RTOL = {torch.float32: 4e-6, torch.float64: 1e-12}
# slopes are held as every consumer sees them. All of them multiply a slope
# by a taper that is zero from a geometric slope of TAPER_ZERO on, so a point
# is "live" where at least one of the two versions gives a geometric slope
# below TAPER_ZERO, and "dead" where both lie at or above it.
#   live points: the geometric slopes, saturated at +-TAPER_ZERO, agree within
#     rtol*|want| + atol*TAPER_ZERO except at no more than `cap` of the live
#     points, within far*TAPER_ZERO except at no more than `far_cap` of them,
#     and within loose*TAPER_ZERO everywhere. float32: the rtol and atol of
#     the JAX package's test of its slope kernel; weakly stratified points,
#     whose vertical density difference is the small difference of a thermal
#     and a haline term, carry the rounding of the terms amplified without a
#     bound (seen at 54 M live points: 1.7e-4 of them outside rtol + atol,
#     2 to 3 points beyond 1e-2 of TAPER_ZERO, the worst at 6.8e-2), hence
#     the two caps; the loose band is the relative one of the dead points.
#     float64: no exceptions, 1e-9 of TAPER_ZERO (the same amplification:
#     1.1e-10 seen).
#   dead points: where the slope divides by the -1e-20 clamp (|S| > CLAMPED,
#     riding a cancellation in the numerator) within 5 % of the value, the
#     JAX package's allowance; elsewhere within dead_rel of the value; or
#     both versions steeper than STEEP: the vertical density difference is
#     within rounding of zero and the two evaluation orders land on different
#     sides of the clamp (1e5 in one, 1e15 in the other).
# N^2 has no taper: every point is live, the scale is the field's largest
# value.
SLOPE_BAND = {
    torch.float32: dict(rtol=3e-4, atol=1e-6, cap=5e-4, far=1e-2,
                        far_cap=1e-6, loose=0.5, dead_rel=0.5),
    torch.float64: dict(rtol=1e-12, atol=1e-9, cap=0.0, far=1e-9,
                        far_cap=0.0, loose=1e-9, dead_rel=1e-8)}
N2_BAND = {
    torch.float32: dict(rtol=3e-4, atol=1e-6, cap=5e-4, far=2e-5,
                        far_cap=0.0, loose=2e-5),
    torch.float64: dict(rtol=1e-12, atol=1e-12, cap=0.0, far=1e-12,
                        far_cap=0.0, loose=1e-12)}
CLAMPED = 1.0e8
STEEP = 3.0        # geometric slope far beyond any that is not tapered away
TAPER_ZERO = 0.18  # the notanh taper is zero from 0.6 of the slope limit on
# whole-path bands, kernels against plain versions over one step, relative to
# each field's scale. float64: the parity band of the JAX package's step-5
# test on every field. float32 is looser, by field: tracers get the band of
# the JAX package's own float32 kernel-dispatch test; the surface pressure is
# the solution of an ill-conditioned 2-D elliptic problem whose right-hand
# side (the vertical mean of a forcing made of large cancelling terms) carries
# float32 rounding, so two correct float32 runs differ there by about 1e-2
# during spin-up from rest, and the velocities inherit it through its gradient.
# That band alone would pass a slightly wrong float32 kernel, so the float32
# comparison also holds both runs against the float64 run of the same steps:
# the run with the kernels may lie at most WITNESS_RATIO times as far from it
# as the run with the plain versions does, on every field
PATH_FIELDS = ("u_cur", "v_cur", "tracer_cur", "psurf_cur", "ubtrop_cur",
               "vbtrop_cur")
PATH_BAND = {
    torch.float64: dict.fromkeys(PATH_FIELDS, 1e-7),
    torch.float32: {"tracer_cur": 1e-4, "u_cur": 1e-2, "v_cur": 1e-2,
                    "psurf_cur": 5e-2, "ubtrop_cur": 5e-2,
                    "vbtrop_cur": 5e-2},
}

WITNESS_RATIO = 1.5
# prod_dyn in float32 takes no fixed band: after five steps from the
# stratified state its float32 runs, with the kernels and with the plain
# versions alike, lie up to a fifth of scale from the float64 run (v_cur,
# on an H100; PERF.md): its thresholds (frazil ice, the upwind direction of
# upwind3, the notanh taper) turn float32 rounding into different decisions,
# and the Robert filter's conservation sums run in float32. There the kernel
# run may differ from the plain run by at most WITNESS_RATIO times the plain
# run's own distance from the float64 run, besides the witness test below.
# prod_mix has the same thresholds and KPP's first crossing of the critical
# bulk Richardson number besides.
# prod_eg, prod_aniso and prod_bgc are prod_full's menu; core_lw's limiter
# (lw_lim)
# chooses its stencil by the signs of tracer differences, another threshold.
WITNESS_BAND_PATHS = ("prod_dyn", "prod_mix", "prod_full", "prod_vmix",
                      "prod_hmix", "prod_eg", "prod_aniso", "core_lw",
                      "prod_pbc", "gm_pbc", "prod_forced", "prod_bgc",
                      "prod_file", "gx3v7")

SOURCES = {
    "thomas": ("pop2_tpu_torch/csrc/thomas.cu",
               "pop2_tpu/tridiag_pallas.py:112"),
    "tracer": ("pop2_tpu_torch/csrc/tracer.cu",
               "pop2_tpu/tracer_pallas.py:563"),
    "clinic": ("pop2_tpu_torch/csrc/clinic.cu",
               "pop2_tpu/clinic_pallas.py:461"),
    "tracer_advdiff": ("pop2_tpu_torch/csrc/tracer.cu",
                       "pop2_tpu/tracer_pallas.py:563"),
    "gm_slope": ("pop2_tpu_torch/csrc/gm_slope.cu",
                 "pop2_tpu/gm_slope_pallas.py:398"),
    "gm_chain": ("pop2_tpu_torch/csrc/gm_chain.cu",
                 "pop2_tpu/gm_chain_pallas.py:612"),
    "gm_flux": ("pop2_tpu_torch/csrc/gm_flux.cu",
                "pop2_tpu/gm_pallas.py:358"),
    "tracer_upwind3": ("pop2_tpu_torch/csrc/tracer.cu",
                       "pop2_tpu/tracer_pallas.py:563"),
    "tracer_upwind3_nt5": ("pop2_tpu_torch/csrc/tracer.cu",
                           "pop2_tpu/tracer_pallas.py:563"),
    "clinic_aniso": ("pop2_tpu_torch/csrc/clinic.cu",
                     "pop2_tpu/clinic_pallas.py:461"),
    "gm_slope_tripole": ("pop2_tpu_torch/csrc/gm_slope.cu",
                         "pop2_tpu/gm_slope_pallas.py:398"),
    "gm_chain_tripole": ("pop2_tpu_torch/csrc/gm_chain.cu",
                         "pop2_tpu/gm_chain_pallas.py:612"),
    "gm_chain_sm": ("pop2_tpu_torch/csrc/gm_chain.cu",
                    "pop2_tpu/gm_chain_pallas.py:612"),
    "gm_chain_sm_nt5": ("pop2_tpu_torch/csrc/gm_chain.cu",
                        "pop2_tpu/gm_chain_pallas.py:612"),
    "gm_chain_sm_nt5_diags": ("pop2_tpu_torch/csrc/gm_chain.cu",
                              "pop2_tpu/gm_chain_pallas.py:612"),
    # no Pallas kernel: the JAX package's jnp search between its GM kernels
    "gm_tlt_search": ("pop2_tpu_torch/csrc/gm_tlt.cu",
                      "pop2_tpu/gm.py:304"),
    "thomas_nr3": ("pop2_tpu_torch/csrc/thomas.cu",
                   "pop2_tpu/tridiag_pallas.py:112"),
    "thomas_nr4": ("pop2_tpu_torch/csrc/thomas.cu",
                   "pop2_tpu/tridiag_pallas.py:112"),
    "gm_flux_tripole": ("pop2_tpu_torch/csrc/gm_flux.cu",
                        "pop2_tpu/gm_pallas.py:358"),
    "clinic_topostress": ("pop2_tpu_torch/csrc/clinic.cu",
                          "pop2_tpu/clinic_pallas.py:461"),
    "gm_flux_aniso": ("pop2_tpu_torch/csrc/gm_flux.cu",
                      "pop2_tpu/gm_pallas.py:358"),
    "thomas_pbc": ("pop2_tpu_torch/csrc/thomas.cu",
                   "pop2_tpu/tridiag_pallas.py:112"),
    "tracer_upwind3_pbc": ("pop2_tpu_torch/csrc/tracer.cu",
                           "pop2_tpu/tracer_pallas.py:563"),
    "clinic_pbc": ("pop2_tpu_torch/csrc/clinic.cu",
                   "pop2_tpu/clinic_pallas.py:461"),
    "gm_chain_sm_nt39": ("pop2_tpu_torch/csrc/gm_chain.cu",
                         "pop2_tpu/gm_chain_pallas.py:612"),
    "gm_flux_tripole_nt39": ("pop2_tpu_torch/csrc/gm_flux.cu",
                             "pop2_tpu/gm_pallas.py:358"),
}
# the path whose launch count each kernel's record carries
PATH_OF = {"thomas": "core", "tracer": "core", "clinic": "core",
           "tracer_advdiff": "gm_full", "gm_slope": "gm_full",
           "gm_chain": "gm_full", "gm_flux": "gm_flux",
           "tracer_upwind3": "prod_dyn", "clinic_aniso": "prod_dyn",
           "gm_slope_tripole": "prod_dyn", "gm_chain_tripole": "prod_dyn",
           "gm_chain_sm": "prod_mix", "gm_tlt_search": "prod_mix",
           "gm_chain_sm_nt5": "prod_full", "tracer_upwind3_nt5": "prod_full",
           "gm_chain_sm_nt5_diags": "prod_full_tavg",
           "thomas_nr3": "prod_full", "thomas_nr4": "prod_full",
           "gm_flux_tripole": "prod_flux", "clinic_topostress": "core_topo",
           "gm_flux_aniso": "prod_aniso", "thomas_pbc": "prod_pbc",
           "tracer_upwind3_pbc": "prod_pbc", "clinic_pbc": "prod_pbc",
           # no path runs the flux assembly on 39 tracers (prod_bgc's GM is
           # the chain's): its record carries the kernel's count on prod_flux
           "gm_chain_sm_nt39": "prod_bgc", "gm_flux_tripole_nt39": "prod_flux"}
# the launch counter each record's kernel adds to
COUNTER_OF = {"tracer_advdiff": "tracer", "tracer_upwind3": "tracer",
              "tracer_upwind3_nt5": "tracer",
              "clinic_aniso": "clinic", "gm_slope_tripole": "gm_slope",
              "gm_chain_tripole": "gm_chain", "gm_chain_sm": "gm_chain",
              "gm_chain_sm_nt5": "gm_chain",
              "gm_chain_sm_nt5_diags": "gm_chain_diags",
              "gm_tlt_search": "gm_tlt", "gm_flux_tripole": "gm_flux",
              "clinic_topostress": "clinic", "gm_flux_aniso": "gm_flux_aniso",
              "tracer_upwind3_pbc": "tracer_pbc",
              "gm_chain_sm_nt39": "gm_chain",
              "gm_flux_tripole_nt39": "gm_flux"}

# the GM configurations over the dynamical core's menu
GM_FULL = dict(hmix_tracer="gm", gm_transition_layer=True,
               gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
               gm_kappa_isop_deep=0.2, gm_kappa_thic_deep=0.1,
               gm_ah=3.0e7, gm_ah_bolus=3.0e7, gm_ah_bkg_srfbl=3.0e7,
               lsubmeso=False)
GM_FLUX = dict(hmix_tracer="gm", gm_transition_layer=False, lsubmeso=False)
# the production gx1v7 preset without KPP, tidal mixing, the submesoscale
# scheme and passive tracers (prod_dyn), and without passive tracers only
# (prod_mix)
PROD_DYN = dict(vmix="rich", ltidal_mixing=False, lsubmeso=False,
                passive_tracers=(), nt=2)
PROD_MIX = dict(passive_tracers=(), nt=2)
# the whole production configuration, and without the transition layer
PROD_FLUX = dict(gm_transition_layer=False)
# the production configuration with the vertical-mixing options a CESM user
# switches on for a mixing study or a spin-up (depth acceleration: the time
# configuration's, ``path_config``)
PROD_VMIX = dict(tidal_mixing_method="polzin", ltidal_lunar_cycle=True,
                 lniw_mixing=True, niw_energy_type="blke",
                 geoheatflux_const=0.1)
# the biharmonic menu of the eddy-resolving tx0.1v3 preset on the gx1v7
# shape, with Schmittner tidal mixing and velocity damping
PROD_HMIX = dict(hmix_tracer="del4", hmix_momentum="del4",
                 tidal_mixing_method="schmittner", ltidal_schmittner_socn=True,
                 ldamp_uv=True, passive_tracers=(), nt=2)
# the rest of the horizontal-mixing and advection menu: Eden-Greatbatch
# diffusivities (a CESM user who switches GM's diffusivity), flow-dependent
# anisotropic GM with Visbeck diffusivities (a study of eddy diffusivity
# that suppresses cross-stream transport), and on the dynamical core the
# flux-limited advection, the polynomial equation of state and GM under it
# with the depth profile and differing types
PROD_EG = dict(gm_kappa_isop_type="eg", gm_kappa_thic_type="eg")
PROD_ANISO = dict(gm_transition_layer=False, gm_aniso="flow",
                  gm_kappa_isop_type="vmhs", gm_kappa_thic_type="vmhs")
CORE_LW = dict(tadvect="lw_lim", state_choice="polynomial",
               hmix_tracer="gm", gm_transition_layer=False,
               gm_kappa_isop_type="depth", gm_kappa_thic_type="const",
               lsubmeso=False)
# partial bottom cells (the bottom-cell file is written by ``path_config``):
# the eddy-resolving preset's menu on the gx1v7 shape, and the production
# configuration
PROD_PBC = dict(PROD_HMIX, partial_bottom_cells=True)
GM_PBC = dict(partial_bottom_cells=True)
# the production configuration under the forcing of an ocean-only run:
# chlorophyll from the forcing, the estuary box model at the river points,
# interior T/S restoring to the bottom over a year (the depth:
# ``path_config``), bulk-NCEP freshwater with P - E as a real freshwater
# flux; each step's forcing composed by ``ForcedForcing``
PROD_FORCED = dict(sw_absorption="chlorophyll", chl_option="file",
                   lestuary_exch=True, sfwf_formulation="bulk-NCEP",
                   lfw_as_salt_flx=False,
                   pt_interior_restore_tau_days=365.0,
                   s_interior_restore_tau_days=365.0)
# the production configuration with CESM's ocean biogeochemistry: the
# 32-tracer ecosystem and the abiotic DIC/DIC14 beside the ideal age and the
# CFCs (nt = 39), the ecosystem's surface chlorophyll in the shortwave
# absorption; the GM chain kernel in three launches of 13 tracers a step
PROD_BGC = dict(passive_tracers=("iage", "cfc", "ecosys", "abio_dic"),
                nt=39, chl_option="model")
PATHS = {"core": {}, "gm_full": GM_FULL, "gm_flux": GM_FLUX,
         "prod_dyn": PROD_DYN, "prod_mix": PROD_MIX, "prod_full": {},
         "prod_flux": PROD_FLUX, "prod_vmix": PROD_VMIX,
         "prod_hmix": PROD_HMIX, "core_topo": dict(ltopostress=True),
         "prod_eg": PROD_EG, "prod_aniso": PROD_ANISO, "core_lw": CORE_LW,
         "prod_pbc": PROD_PBC, "gm_pbc": GM_PBC,
         "prod_forced": PROD_FORCED, "prod_bgc": PROD_BGC,
         # the file grids' options come from ``gx_files`` (``full_config``)
         "prod_file": {}, "gx3v7": {}}
PROD_PATHS = ("prod_dyn", "prod_mix", "prod_full", "prod_flux", "prod_vmix",
              "prod_hmix", "prod_eg", "prod_aniso", "prod_pbc",
              "prod_forced", "prod_bgc")
PASSIVE_PATHS = ("prod_full", "prod_flux", "prod_vmix", "prod_eg",
                 "prod_aniso", "gm_pbc", "prod_forced", "prod_bgc",
                 "prod_file")
# the bottom-cell files of the partial-cell paths, a file a grid shape, and
# prod_forced's wind-stress files, in directories removed at exit
BOTTOM_CELLS = tempfile.TemporaryDirectory(prefix="pop2_dzbc_")
WIND_FILES = tempfile.TemporaryDirectory(prefix="pop2_ws_")
# the years the calendar jumps in run_loop_phase's lunar check
LUNAR_JUMP_YEARS = 7
# the 10-m wind speed squared of the passive paths' forcing (7 m/s), without
# which the CFC fluxes are zero
U10_SQR = 4.9e5
# the small grid of the GPU-against-CPU comparison of the production paths;
# prod_bgc's on 20 internal levels, since uniform ones put the ecosystem's
# whole photic zone in the first level
PROD_SMALL = dict(nx=40, ny=24, km=10, vert_grid="uniform")
BGC_SMALL = dict(nx=40, ny=24, km=20, vert_grid="internal")
# the ecosystem's first slot on prod_bgc: after T, S, the age and the CFCs
BGC_SLOT0 = 5
# the gx-class grids read from files: prod_file's (gx1v7's shape, from the
# script's seed), gx3v7's (as the JAX package's tests/test_gx3v7.py writes
# it) and the small one of the comparisons with the CPU, each written once
# by ``gridgen.generate_gx_files`` into a directory removed at exit
GX_FILES = tempfile.TemporaryDirectory(prefix="pop2_gx_")
GX1 = (320, 384, 60, SEED)
GX3 = (100, 116, 60, 0)
GX_SMALL = (40, 24, 12, SEED)
_GX_PATHS = {}
# the forcing functions on the GPU against the CPU in float64, relative to
# each output's scale
FORCING_BAND = 1e-12


def emit(obj):
    print(json.dumps(obj), flush=True)


def gx_files(nx: int, ny: int, km: int, seed: int) -> dict:
    """The config options of a gx-class grid read from the files that
    ``gridgen.generate_gx_files`` writes for these dimensions and seed
    (written at the first call)."""
    key = (nx, ny, km, seed)
    if key not in _GX_PATHS:
        _GX_PATHS[key] = gridgen.generate_gx_files(
            os.path.join(GX_FILES.name, "gx_%d_%d_%d_%d" % key), nx, ny, km,
            seed=seed)
    paths = _GX_PATHS[key]
    return dict(nx=nx, ny=ny, km=km, horiz_grid="file", vert_grid="file",
                topography="file", horiz_grid_file=paths["horiz"],
                vert_grid_file=paths["vert"], topography_file=paths["topo"])


def full_config(dtype: str, path: str = "core"):
    """One of the port's paths at the production gx1v7 dimensions (gx3v7's
    own on its path). Under a float32 model the 2-D solve runs in float64,
    as the production preset does: in float32 the residual floor of the
    solve lies above the convergence criterion of 1e-13 and ChronGear runs
    to max_iterations every step (in the JAX package too)."""
    if path == "prod_file":
        return production.get_production_config(dtype=dtype,
                                                **gx_files(*GX1))
    if path == "gx3v7":
        return get_config("gx3v7", dtype=dtype,
                          solver=SolverConfig(solve_dtype="float64"),
                          **gx_files(*GX3))
    if path in PASSIVE_PATHS:  # the flagship's entry point
        cfg = production.get_production_config(dtype=dtype, **PATHS[path])
    elif path in PROD_PATHS:  # PCSI 1e-13 with FSPAI, solving in float64
        cfg = get_config("prod_full", dtype=dtype, **PATHS[path])
    else:
        solver = SolverConfig(solve_dtype="float64")
        cfg = get_config("test", nx=320, ny=384, km=60, vmix="rich",
                         dtype=dtype, solver=solver, **PATHS[path])
    return path_config(cfg, path)


def bottom_cell_file(cfg):
    """The bottom-cell file of a partial-cell config's grid: the bottom
    level of every ocean column a seeded fraction in [0.25, 1] of its full
    thickness (``sample.write_bottom_cells`` on the full-cell grid's KMT,
    built on the host), written once a grid shape. Prints the columns whose
    bottom level is thinner than dz at T and at U points."""
    full = cfg.with_(partial_bottom_cells=False, bottom_cell_file=None)
    key = (full.nx, full.ny, full.km, full.vert_grid, full.ew_boundary,
           full.ns_boundary, full.n_topo_smooth)
    path = os.path.join(BOTTOM_CELLS.name, "dzbc_" + "_".join(
        str(k) for k in key) + ".ieeer8")
    if not os.path.exists(path):
        grid = build_grid(full.with_(hmix_momentum="del2",
                                     ltopostress=False), "cpu")
        kmt, kmu = grid.KMT.numpy(), grid.KMU.numpy()
        dz = vertical_dz(full)
        sample.write_bottom_cells(path, kmt, dz, SEED + 31)
        named = cfg.with_(bottom_cell_file=path)
        dzt, dzu, _, _ = partial_bottom_cells(
            named, dz, np.concatenate([[0.0], np.cumsum(dz)]), kmt, kmu,
            bottom_cells(named, dz, kmt))
        out = {"phase": "bottom_cells", "dims": [cfg.nx, cfg.ny, cfg.km]}
        for pt, kmax, plane in zip("tu", (kmt, kmu), bottom_planes(
                dz, dzt, dzu, kmt, kmu)):
            wet = kmax > 0
            out[f"columns_{pt}"] = int(wet.sum())
            out[f"thinner_{pt}"] = int(
                (wet & (plane < dz[np.maximum(kmax, 1) - 1])).sum())
            out[f"bottom_levels_{pt}"] = sorted(
                int(k) for k in np.unique(kmax[wet]))[:8]
        emit(out)
    return path


def path_config(cfg, path: str):
    """``cfg`` with what a path takes from its size: prod_vmix's depth
    acceleration, 1 down to 1000 m and 2 at the bottom level
    (``sample.depth_accel_profile`` over the config's level centres); the
    partial-cell paths' bottom-cell file (``bottom_cell_file``);
    prod_forced's interior restoring down to the bottom level."""
    if cfg.partial_bottom_cells:
        return cfg.with_(bottom_cell_file=bottom_cell_file(cfg))
    if path == "prod_forced":
        return cfg.with_(pt_interior_restore_max_level=cfg.km,
                         s_interior_restore_max_level=cfg.km)
    if path != "prod_vmix":
        return cfg
    dz = vertical_dz(cfg)
    zt = np.cumsum(dz) - 0.5 * dz
    return cfg.with_(time=dataclasses.replace(
        cfg.time, laccel=True, dttxcel=sample.depth_accel_profile(zt)))


def path_forcing(model):
    """The forcing of a path's steps: None (the model's own) without
    passive tracers; with them the model's own under a constant 10-m wind
    (U10_SQR) and no sea ice."""
    if not model.cfg.passive_tracers:
        return None
    f = model.forcing
    return f.replace(u10_sqr=torch.full_like(f.fw, U10_SQR),
                     ifrac=torch.zeros_like(f.fw))


# prod_forced's climatologies at the model's hour, and their interpolation
FORCED_CLIMS = {"windspd": "4point", "tair": "linear", "qair": "linear",
                "qsw": "linear", "cldfrac": "linear", "sst": "linear",
                "sss": "linear", "precip": "linear", "chl": "linear"}


def model_hour(model) -> float:
    """The model's hour of its year, from its calendar."""
    cal = model.time_manager.calendar
    return (cal.year_fraction - cal.iyear) * forcing_tools.HOURS_PER_YEAR


def wind_file(cfg, taux, tauy) -> str:
    """``taux``/``tauy`` (12, ny, nx) written as one POP-format monthly
    wind-stress file (``forcing.read_ws_file``'s layout: 12 records of the
    (TAUX, TAUY) pair, big-endian float64), a file a grid shape."""
    path = os.path.join(WIND_FILES.name, f"ws_{cfg.nx}_{cfg.ny}.ieeer8")
    np.stack([taux, tauy], axis=1).astype(">f8").tofile(path)
    return path


class ForcedForcing:
    """prod_forced's forcing of a step, composed around ``Model.advance`` as
    the JAX package's tests compose a standalone forced run (and as
    ``tests/test_torch_forcing.py`` does in both packages): the monthly
    wind stress of a file (``file_wind_stress``); the bulk-NCEP heat flux
    (``bulk_ncep``) and freshwater flux (``set_sfwf``, with the latent flux
    of ``sen_lat_flux``) from 12-month seeded climatologies at the model's
    hour (``sample.forcing_climatology``: 'linear', the wind speed
    '4point') and the model's own SST and SSS; the marginal sea's salt and
    freshwater fluxes balanced (``ms_balancing``); the runoff's virtual
    salt flux (``river_vsf``); the chlorophyll at the model's hour; the
    runoff at seeded coast points; the interior targets, the initial T/S
    plus seeded noise; a 7 m/s wind and no ice (``path_forcing``). The
    climatologies, the file's wind stress, the marginal sea and the targets
    are made once, on the model's device."""

    def __init__(self, cfg, grid, passive=None, seed: int = SEED + 41):
        dev, dt = grid.KMT.device, cfg.torch_dtype
        tr = initial_state(cfg, grid, dev, passive=passive
                           ).tracer_cur.double().cpu().numpy()
        clim = sample.forcing_climatology(
            grid.kmask_t.cpu().numpy(), grid.TLAT.double().cpu().numpy(),
            tr[0, 0], tr[1, 0], seed)
        taux, tauy = forcing_mod.read_ws_file(
            wind_file(cfg, clim["taux"], clim["tauy"]), cfg.ny, cfg.nx)
        self.ws = [forcing_tools.MonthlyClimatology.create(a, device=dev)
                   for a in (taux, tauy)]
        self.clims = {k: forcing_tools.MonthlyClimatology.create(
            clim[k], interp, device=dev)
            for k, interp in FORCED_CLIMS.items()}
        self.region = ms_balance.build_region(grid, clim["ms_mask"],
                                              clim["ms_points"])

        def tensor(a):
            return torch.as_tensor(a, device=dev).to(dt)
        self.roff = tensor(clim["roff"])
        self.targets = (tensor(tr[0] + clim["t_noise"]),
                        tensor(tr[1] + clim["s_noise"]))
        self.river_points = int((clim["roff"] > 0).sum())

    def surface_fluxes(self, cfg, grid, base, sst, sss, thour):
        """{name: tensor} of the step's surface fields (float64 where the
        climatologies are)."""
        f = forcing_mod.file_wind_stress(cfg, grid, base, *self.ws, thour)
        data = {k: c.at(thour) for k, c in self.clims.items()}
        stf_t, qsw = forcing_shf.bulk_ncep(cfg, grid, sst, data)
        _, qlat = forcing_shf.sen_lat_flux(data["windspd"], sst,
                                           data["tair"], data["qair"])
        out = forcing_sfwf.set_sfwf(cfg, grid, data["sss"], sss,
                                    sst_surf=sst, qlat=qlat,
                                    precip_data=data["precip"],
                                    ocn_wgt=grid.RCALCT)
        salt, fw = (ms_balance.ms_balancing(cfg, grid, x, [self.region])
                    for x in (out.stf_salt, out.fw))
        salt = salt + estuary.river_vsf(cfg, grid, self.roff, sss)
        return dict(smf=f.smf, smft=f.smft, stf_t=stf_t, salt=salt,
                    shf_qsw=qsw, fw=fw, tfw_t=out.tfw_temp, chl=data["chl"])

    def __call__(self, model, state):
        """The forcing of ``model``'s next step from ``state``."""
        return self.compose(model.cfg, model.grid, model.forcing, state,
                            model_hour(model))

    def compose(self, cfg, grid, base, state, thour):
        """``base`` with the fields of a step at hour ``thour`` from
        ``state``."""
        dt = cfg.torch_dtype
        d = self.surface_fluxes(cfg, grid, base, state.tracer_cur[0, 0],
                                state.tracer_cur[1, 0], thour)
        stf, tfw = base.stf.clone(), base.tfw.clone()
        stf[0], stf[1], tfw[0] = d["stf_t"], d["salt"], d["tfw_t"]
        return base.replace(
            smf=d["smf"].to(dt), smft=d["smft"].to(dt), stf=stf, tfw=tfw,
            shf_qsw=d["shf_qsw"].to(dt), fw=d["fw"].to(dt),
            chl=d["chl"].to(dt), roff_f=self.roff,
            pt_interior_data=self.targets[0],
            s_interior_data=self.targets[1],
            u10_sqr=torch.full_like(base.fw, U10_SQR),
            ifrac=torch.zeros_like(base.fw))


def step_forcing(path: str, model):
    """A function of the model and the state before a step that gives the
    step's forcing: prod_forced's composed from that state
    (``ForcedForcing``), every other path's the same each step
    (``path_forcing``)."""
    if path == "prod_forced":
        return ForcedForcing(model.cfg, model.grid, model.passive)
    forcing = path_forcing(model)
    return lambda model, state: forcing


def time_ms(fn, n_warm: int, n_timed: int) -> float:
    """Median time of one call, by CUDA events around each call (the host's
    time in the call counts where the card waits for it)."""
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def time_ms_back_to_back(fn, n_calls: int, n_rounds: int = 3) -> float:
    """Time of one call where calls follow each other: CUDA events around
    ``n_calls`` calls back to back, divided by ``n_calls``, the median over
    ``n_rounds`` rounds (after three calls of warm-up). The host queues the
    next launch while the card runs the last, so this is the kernel's own
    time wherever it is longer than the wrapper's host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n_calls)
    times.sort()
    return times[len(times) // 2]


def compare(name, dtype, got, want):
    """(max abs err, err relative to the reference's scale) over all outputs;
    raises if the band is broken or anything is not finite."""
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {dtype}: kernel output not finite")
        scale = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    band = BAND[(name, dtype)]
    if not worst_rel <= band:
        raise AssertionError(
            f"{name} {dtype}: kernel differs from plain version by "
            f"{worst_rel:.3e} of scale, band {band:.1e}")
    return worst_abs, worst_rel


def _require_finite(name, dtype, tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} {dtype}: kernel output not finite")


def true_slope_factors(grid):
    """Factors that turn the slope kernel's outputs into geometric slopes,
    one per output: the quarter-cell slopes are differences across a face
    over differences across a level (times dzw / dx or dy), the slope
    measure is a geometric slope already, N^2 has none."""
    vg = grid.vgrid
    km = vg.dz.shape[0]
    dzw = torch.stack([vg.dzw[0:km], vg.dzw[1:km + 1]])       # (half, km)
    planes = torch.stack([dzw[h].reshape(km, 1, 1) / d
                          for d in (grid.DXT, grid.DXT, grid.DYT, grid.DYT)
                          for h in (0, 1)])
    return planes, 1.0, None


def compare_slopes(name, dtype, got, want, factors):
    """The slope kernel's outputs against the plain version's at SLOPE_BAND
    and N2_BAND (see there); ``factors`` turn each output into a geometric
    slope (None: no taper applies, every point is live). Returns a record:
    the largest error over the live points (of the saturated geometric
    slope; for N^2 of the value) absolute and relative to its scale, the
    live points outside rtol + atol and beyond the far band, and the dead
    points by the rule that passed them."""
    out = {"max_abs_err": 0.0, "rel_err": 0.0, "live_points": 0,
           "live_points_beyond_rtol_atol": 0, "live_points_far": 0,
           "clamped_points": 0,
           "steep_points_passed": 0}
    _require_finite(name, dtype, got)
    for g, w, factor in zip(got, want, factors):
        band = (N2_BAND if factor is None else SLOPE_BAND)[dtype]
        if factor is None:
            live = torch.ones_like(w, dtype=torch.bool)
            scale = float(w.abs().max()) or 1.0
            err, ref = (g - w).abs(), w.abs()
        else:
            gg, gw = g * factor, w * factor
            live = (gg.abs() < TAPER_ZERO) | (gw.abs() < TAPER_ZERO)
            scale = TAPER_ZERO
            sat = gw.clamp(-scale, scale)
            err, ref = (gg.clamp(-scale, scale) - sat).abs(), sat.abs()
        n_live = int(live.sum())
        beyond = int((live & (err > band["rtol"] * ref
                              + band["atol"] * scale)).sum())
        far = int((live & (err > band["far"] * scale)).sum())
        worst = float(err[live].max())
        if (beyond > band["cap"] * n_live or far > band["far_cap"] * n_live
                or worst > band["loose"] * scale):
            raise AssertionError(
                f"{name} {dtype}: of {n_live} live points {beyond} off the "
                f"plain version beyond rtol {band['rtol']:.0e} + "
                f"{band['atol']:.0e} of scale {scale:.3e} (cap "
                f"{band['cap']:.0e} of them), {far} beyond "
                f"{band['far']:.0e} of scale (cap {band['far_cap']:.0e}), "
                f"the worst by {worst / scale:.3e} of scale (band "
                f"{band['loose']:.0e})")
        out["live_points"] += n_live
        out["live_points_beyond_rtol_atol"] += beyond
        out["live_points_far"] += far
        out["max_abs_err"] = max(out["max_abs_err"], worst)
        out["rel_err"] = max(out["rel_err"], worst / scale)
        if factor is None:
            continue
        aw, raw_err = w.abs(), (g - w).abs()
        clamped = aw > CLAMPED
        close = raw_err <= torch.where(clamped, 5e-2, band["dead_rel"]) * aw
        steep = (gg.abs() > STEEP) & (gw.abs() > STEEP)
        bad = ~live & ~close & ~steep
        if bool(bad.any()):
            shown = [(tuple(i.tolist()), float(g[tuple(i)]),
                      float(w[tuple(i)])) for i in bad.nonzero()[:5]]
            raise AssertionError(
                f"{name} {dtype}: {int(bad.sum())} tapered-away points off "
                f"the plain version; (index, kernel, plain): {shown}")
        out["clamped_points"] += int(clamped.sum())
        out["steep_points_passed"] += int((~live & ~close).sum())
    return out


def chain_band(name, dtype, g, w):
    """(|g - w|, scale of w, points outside the band of scale, whether every
    such point lies within GM_CHAIN_REL of its value)."""
    band, rel = BAND[(name, dtype)], GM_CHAIN_REL[dtype]
    aw = w.abs()
    scale = float(aw.max()) or 1.0
    err = (g - w).abs()
    far = err > band * scale
    return err, scale, far, bool((~far | (err <= rel * aw)).all())


def compare_chain(name, dtype, got, want):
    """Each output within BAND of the field's scale or GM_CHAIN_REL of the
    value. Returns (max abs err, worst err over scale, points excused by the
    relative band)."""
    band, rel = BAND[(name, dtype)], GM_CHAIN_REL[dtype]
    worst_abs, worst_rel, excused = 0.0, 0.0, 0
    _require_finite(name, dtype, got)
    for g, w in zip(got, want):
        err, scale, far, holds = chain_band(name, dtype, g, w)
        if not holds:
            raise AssertionError(
                f"{name} {dtype}: kernel differs from plain version by "
                f"{float(err.max()) / scale:.3e} of scale, band {band:.1e} "
                f"of scale or {rel:.0e} of the value")
        excused += int(far.sum())
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, float(err.max()) / scale)
    return worst_abs, worst_rel, excused


def chain_fold_share(name, dtype, cfg, args, want_gtk):
    """How far the tripole fold moves the top row of the plain chain's GTK
    (the same inputs with a closed north edge against ``want_gtk``), over
    its scale there. Fails where that is not far above the band: the
    comparison of the kernel's top row would then not see the fold."""
    c = cfg.with_(ns_boundary="closed")
    closed = gm_chain_cuda.chain_plain(c, args[1], grid_bc(c), *args[3:])[0]
    top = want_gtk[..., -1, :]
    share = float((closed[..., -1, :] - top).abs().max() / top.abs().max())
    if not share > 100.0 * BAND[("gm_chain", dtype)]:
        raise AssertionError(f"{name} {dtype}: the fold moves the top row "
                             f"by {share:.2e} only; the check cannot see it")
    return share


def tracer_fold_share(name, dtype, args, want):
    """How far the tripole fold moves the top row of the plain tracer
    tendency (the same inputs, ``args`` of the wrapper, with a closed north
    edge against ``want``), over its scale there. Fails where that is not
    far above the band: the comparison of the kernel's top row would then
    not see the fold."""
    c = args[0].with_(ns_boundary="closed")
    closed = tracer_cuda.tracer_tendency_plain(c, *args[1:])
    top = want[..., -1, :]
    share = float((closed[..., -1, :] - top).abs().max() / top.abs().max())
    if not share > 100.0 * BAND[("tracer", dtype)]:
        raise AssertionError(f"{name} {dtype}: the fold moves the top row "
                             f"by {share:.2e} only; the check cannot see it")
    return share


def compare_search(name, dtype, got, want):
    """The search kernel's TLT against the plain version's: the integer
    fields equal, the depths within BAND of scale. Returns (max abs err, err
    over scale, bitwise or not)."""
    for field in ("k_level", "ztw"):
        g, w = getattr(got, field), getattr(want, field)
        if not torch.equal(g, w):
            raise AssertionError(
                f"{name} {dtype}: {field} differs from the plain version at "
                f"{int((g != w).sum())} columns")
    err_abs, err_rel = compare(
        name, dtype, [got.thickness, got.interior_depth],
        [want.thickness, want.interior_depth])
    bitwise = all(torch.equal(getattr(got, f), getattr(want, f))
                  for f in ("thickness", "interior_depth"))
    return err_abs, err_rel, bitwise


def mixed_layer(depth, seed: int):
    """A mixed-layer depth 0.8 to 1.2 times ``depth`` (seeded): the
    submesoscale scheme's input where no KPP run gives one."""
    gen = torch.Generator(device=depth.device)
    gen.manual_seed(seed)
    return depth * (0.8 + 0.4 * torch.rand(depth.shape, generator=gen,
                                           device=depth.device,
                                           dtype=depth.dtype))


def compare_vdc(name, dtype, got, want):
    """VDC_GM point by point at GM_VDC_RTOL; returns the worst relative
    error."""
    rtol = GM_VDC_RTOL[dtype]
    _require_finite(name, dtype, [got])
    err, aw = (got - want).abs(), want.abs()
    if not bool((err <= rtol * aw).all()):
        raise AssertionError(
            f"{name} {dtype}: VDC_GM off the plain version by "
            f"{float(torch.where(aw > 0, err / aw, err).max()):.3e}, rtol "
            f"{rtol:.0e}")
    return float(torch.where(aw > 0, err / aw, 0.0).max())


def bound(nbytes: float, flops: float, dtype):
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def launch_info(name: str, dt, tag: str = "", **kw):
    """Block shape, dynamic shared memory and blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the library's
    ``pop2_*_blocks_per_sm``) of a kernel's launch at the main path's
    shapes, keyed with ``tag``. thomas takes nr and km, gm_chain nt, flags
    and sm, tracer its group's tracer count ng, del2, upwind3 and fold,
    gm_flux nt, cancellation, fold and aniso; gm_tlt (a thread a column)
    nothing.
    The kernels in a frame (tracer, clinic, gm_slope, gm_flux) also report
    their tile of interior columns."""
    lib, code, s = cb.lib(), cb.dtype_code(torch.empty(0, dtype=dt)), \
        torch.finfo(dt).bits // 8
    if name == "thomas":
        cols, smem = tridiag_cuda.launch_plan(s, kw["nr"], kw["km"])
        block = [cols, 1, 1]
        n = lib.pop2_thomas_blocks_per_sm(code, kw["nr"], cols, smem,
                                           int(kw.get("pbc", False)))
    elif name == "gm_chain":
        (cols, rows), smem = gm_chain_cuda.launch_plan(s, kw["nt"],
                                                       kw.get("sm", False))
        block = [cols, rows, 1]
        n = lib.pop2_gm_chain_blocks_per_sm(code, kw["flags"], rows, smem)
    elif name == "tracer":
        upw3, fold = kw.get("upwind3", False), kw.get("fold", False)
        pbc = kw.get("pbc", False)
        (cols, rows), smem = tracer_cuda.launch_plan(s, kw["ng"], kw["del2"],
                                                     upw3, pbc)
        block = [cols, rows, 1]
        n = lib.pop2_tracer_blocks_per_sm(code, int(kw["del2"]), kw["ng"],
                                          int(upw3), int(fold), smem,
                                          int(pbc))
    elif name == "clinic":
        pbc = kw.get("pbc", False)
        (cols, rows), smem = clinic_cuda.launch_plan(s, pbc)
        block = [cols, rows, 1]
        n = lib.pop2_clinic_blocks_per_sm(code, int(kw.get("hdiffu", True)),
                                          smem, int(pbc))
    elif name == "gm_slope":
        (cols, rows), smem = gm_slope_cuda.launch_plan(s)
        block = [cols, rows, 1]
        n = lib.pop2_gm_slope_blocks_per_sm(code, smem)
    elif name == "gm_tlt":
        block, smem = [gm_tlt_cuda.THREADS, 1, 1], 0
        n = lib.pop2_gm_tlt_blocks_per_sm(code)
    else:
        aniso = kw.get("aniso", False)
        (cols, rows), smem = gm_cuda.launch_plan(s, kw["nt"],
                                                 kw["cancellation"], aniso)
        block = [cols, rows, 1]
        n = lib.pop2_gm_flux_blocks_per_sm(code, kw["nt"],
                                           int(kw["cancellation"]),
                                           int(kw.get("fold", False)),
                                           int(aniso), smem)
    if n <= 0:
        raise AssertionError(f"{name}: occupancy query failed ({n})")
    info = {"block" + tag: block, "dynamic_smem_bytes" + tag: smem,
            "blocks_per_sm" + tag: n,
            "warps_per_sm" + tag: n * block[0] * block[1] // 32}
    if name not in ("thomas", "gm_chain", "gm_tlt"):  # a tile in a frame
        info["tile" + tag] = block[:2]
    return info


def aniso_kisop_y(kisop):
    """The y faces' isopycnal diffusivity of an anisotropic check: the x
    faces' (``kisop``, (2, km, ny, nx)) times 0.3 in the upper half of the
    column and 1.7 below (the CPU tests' pattern)."""
    km = kisop.shape[1]
    lev = torch.arange(km, device=kisop.device).reshape(1, km, 1, 1)
    return (kisop * torch.where(lev < km // 2, 0.3, 1.7)).contiguous()


def random_fields(cfg, grid, gen):
    """Kernel operands with the magnitudes the JAX package's kernel tests
    use, masked to ocean, from the seeded generator."""
    dt = cfg.torch_dtype
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    mu, mt = grid.kmask_u.to(dt), grid.kmask_t.to(dt)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV, dtype=dt)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=DEV, dtype=dt)

    f = {}
    for name in ("ucur", "vcur", "uold", "vold"):
        f[name] = randn(km, ny, nx) * 10.0 * mu
    for name in ("trcr", "tmix", "told"):
        f[name] = randn(nt, km, ny, nx) * mt
    f["vdc"] = rand(2, km, ny, nx) * 10.0 * mt
    f["vvc"] = rand(km, ny, nx) * 10.0 * mu
    f["stf"] = randn(nt, ny, nx) * mt[0]
    f["smf"] = randn(2, ny, nx) * mu[0]
    f["dh"] = randn(ny, nx) * 1e-4 * mt[0]
    f["dhu"] = randn(ny, nx) * 1e-4 * mu[0]
    f["rho"] = [randn(km, ny, nx) * 1e-3 * mt for _ in range(3)]
    f["psurf"] = randn(ny, nx) * 100.0 * mt[0]
    f["rhs"] = randn(2, km, ny, nx) * mt
    return f


def thomas_operands(cfg, grid, f):
    """(hfac, h1, a) of the tracer solve from ``random_fields``."""
    vg, km = grid.vgrid, cfg.km
    c2dt = 2.0 * cfg.time.dtt
    hfac = vg.dz / c2dt
    h1 = (hfac[0] + f["psurf"] / (const.GRAV * c2dt)).contiguous()
    a = cfg.aidif * vg.dzwr[1:km + 1].reshape(km, 1, 1) * f["vdc"][1]
    a[-1] = 0.0
    return hfac, h1, a


def kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """Each kernel against its plain version at the main path's shapes and
    with the main path's aliasing of operands (a leapfrog step: the
    mixing-time fields are the old ones), with times and bounds. A bound
    counts each distinct tensor once. Returns {name: record}."""
    cfg = full_config(dtype_name)
    dt = cfg.torch_dtype
    grid = build_grid(cfg, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    f = random_fields(cfg, grid, gen)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    rec = {}

    # ---- thomas: the tracer solve's operands, nr = 2 and nr = 1 -----------
    hfac, h1, a = thomas_operands(cfg, grid, f)
    r = {}
    for nr in (2, 1):
        rhs = f["rhs"][:nr].contiguous()
        args = (hfac, h1, grid.KMT, a, rhs)
        got = tridiag_cuda.thomas(*args)
        torch.cuda.synchronize()
        want = tridiag_cuda.thomas_plain(*args)
        err_abs, err_rel = compare("thomas", dt, [got], [want])
        ms = time_ms(lambda: tridiag_cuda.thomas(*args), 3, n_timed)
        b2b = time_ms_back_to_back(
            lambda: tridiag_cuda.thomas(*args), n_timed)
        plain_ms = time_ms(lambda: tridiag_cuda.thomas_plain(*args), 1, 3)
        b_ms, b_by = bound(s * (N * (1 + 2 * nr) + P + km) + 4 * P,
                           N * (8 + 5 * nr), dt)
        tag = "" if nr == 2 else "_nr1"
        r.update({"max_abs_err" + tag: err_abs, "rel_err" + tag: err_rel,
                  "ms" + tag: ms, "ms_back_to_back" + tag: b2b,
                  "plain_ms" + tag: plain_ms,
                  "bound_ms" + tag: b_ms, "bound_by" + tag: b_by,
                  **launch_info("thomas", dt, tag, nr=nr, km=km)})
    rec["thomas"] = r
    # nr = 3 and 4: the prod_full path's passive tracers in the leapfrog
    # corrector, and salinity with them on the Euler step
    for nr in (3, 4):
        rhs = torch.randn(nr, km, ny, nx, generator=gen, device=DEV,
                          dtype=dt) * grid.kmask_t.to(dt)
        args = (hfac, h1, grid.KMT, a, rhs)
        got = tridiag_cuda.thomas(*args)
        torch.cuda.synchronize()
        want = tridiag_cuda.thomas_plain(*args)
        err_abs, err_rel = compare("thomas", dt, [got], [want])
        del got, want
        b_ms, b_by = bound(s * (N * (1 + 2 * nr) + P + km) + 4 * P,
                           N * (8 + 5 * nr), dt)
        rec[f"thomas_nr{nr}"] = {
            "max_abs_err": err_abs, "rel_err": err_rel,
            "ms": time_ms(lambda: tridiag_cuda.thomas(*args), 3, n_timed),
            "ms_back_to_back": time_ms_back_to_back(
                lambda: tridiag_cuda.thomas(*args), n_timed),
            "plain_ms": time_ms(lambda: tridiag_cuda.thomas_plain(*args), 1,
                                3),
            "bound_ms": b_ms, "bound_by": b_by,
            **launch_info("thomas", dt, nr=nr, km=km)}

    # ---- tracer tendency ----------------------------------------------------
    # u, v, vdc (2), trcr, told (= tmix) and the output per tracer
    args = (cfg, grid, f["ucur"], f["vcur"], f["trcr"], f["told"], f["told"],
            f["vdc"], f["stf"], f["dh"])
    got = tracer_cuda.tracer_tendency(*args)
    torch.cuda.synchronize()
    want = tracer_cuda.tracer_tendency_plain(*args)
    err_abs, err_rel = compare("tracer", dt, [got], [want])
    ms = time_ms(lambda: tracer_cuda.tracer_tendency(*args), 3, n_timed)
    b2b = time_ms_back_to_back(
        lambda: tracer_cuda.tracer_tendency(*args), n_timed)
    plain_ms = time_ms(lambda: tracer_cuda.tracer_tendency_plain(*args), 1, 3)
    b_ms, b_by = bound(s * (N * (4 + 3 * nt) + P * (nt + 8) + 4 * km) + 4 * P,
                       N * (30 + 45 * nt), dt)
    rec["tracer"] = {"max_abs_err": err_abs, "rel_err": err_rel, "ms": ms,
                     "ms_back_to_back": b2b, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     **launch_info("tracer", dt, ng=nt, del2=True)}

    # ---- momentum forcing (leapfrog, pressure-averaged) ---------------------
    rhoavg = pgrad.rho_average(cfg, grid, f["rho"][0], f["rho"][1],
                               f["rho"][2], True)
    wc, wo = clinic_cuda.coriolis_weights(cfg, True)
    args = (cfg, grid, f["ucur"], f["vcur"], f["uold"], f["vold"], f["uold"],
            f["vold"], rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
    got = clinic_cuda.clinic_rhs_fields(*args)
    torch.cuda.synchronize()
    want = clinic_cuda.clinic_rhs_plain(*args)
    err_abs, err_rel = compare("clinic", dt, got, want)
    ms = time_ms(lambda: clinic_cuda.clinic_rhs_fields(*args), 3, n_timed)
    b2b = time_ms_back_to_back(
        lambda: clinic_cuda.clinic_rhs_fields(*args), n_timed)
    plain_ms = time_ms(lambda: clinic_cuda.clinic_rhs_plain(*args), 1, 3)
    # six distinct 3-D inputs (the mixing-time pair is the old pair again);
    # the kernel reads nothing below a column's bottom: count the inputs of
    # the ocean levels of this grid, and every output value
    wet = float(grid.kmask_u.to(torch.float64).mean())
    b_ms, b_by = bound(s * (N * (6 * wet + 2) + P * (19 + 2 + 1 + 2)
                            + 5 * km) + 4 * P, N * wet * 200, dt)
    rec["clinic"] = {"max_abs_err": err_abs, "rel_err": err_rel, "ms": ms,
                     "ms_back_to_back": b2b, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "ocean_fraction_u": wet,
                     **launch_info("clinic", dt)}

    # ---- the same instance under topographic stress (core_topo): the
    # fused friction fed the departure from TSU/TSV of this grid, formed
    # once a step by plain ops (timed apart as the TSU subtraction)
    tcfg = cfg.with_(ltopostress=True)
    tgrid = grid.replace(**dict(zip(("TSU", "TSV"), (
        torch.as_tensor(a, dtype=dt, device=DEV) for a in build_topostress(
            tcfg, *(getattr(grid, n).double().cpu().numpy() for n in (
                "HT", "KMT", "KMU", "TLAT", "FCORT", "DXUR", "DYUR",
                "HUR")))))))

    def relative():
        return hmix.topostress_relative(tcfg, tgrid, f["uold"], f["vold"])
    um, vm = relative()
    if not float((um - f["uold"]).abs().max()) > 0.0:
        raise AssertionError("topographic stress left the velocities alone")
    args = (tcfg, tgrid, f["ucur"], f["vcur"], f["uold"], f["vold"], um, vm,
            rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
    got = clinic_cuda.clinic_rhs_fields(*args)
    torch.cuda.synchronize()
    want = clinic_cuda.clinic_rhs_plain(*args)
    err_abs, err_rel = compare("clinic", dt, got, want)
    # two more distinct 3-D inputs (um, vm are no longer uold, vold)
    b_ms, b_by = bound(s * (N * (8 * wet + 2) + P * (19 + 2 + 1 + 2)
                            + 5 * km) + 4 * P, N * wet * 200, dt)
    rec["clinic_topostress"] = {
        "max_abs_err": err_abs, "rel_err": err_rel,
        "ms": time_ms(lambda: clinic_cuda.clinic_rhs_fields(*args), 3,
                      n_timed),
        "ms_back_to_back": time_ms_back_to_back(
            lambda: clinic_cuda.clinic_rhs_fields(*args), n_timed),
        "plain_ms": time_ms(lambda: clinic_cuda.clinic_rhs_plain(*args), 1,
                            3),
        "tsu_subtraction_plain_ms": time_ms(relative, 3, n_timed),
        "bound_ms": b_ms, "bound_by": b_by, **launch_info("clinic", dt)}
    return rec


def ts_range_of(cfg, grid):
    """The equation of state's per-level T/S range, as ``Model`` builds it."""
    if cfg.state_range_opt != "enforce":
        return None
    return eos.build_ts_range(grid.vgrid.zt.double().cpu().numpy(),
                              cfg.torch_dtype, grid.KMT.device)


def searched_inputs(cfg, grid, sla, seed: int):
    """(diabatic depth, slope measure) under which the transition-layer
    search has its second and third sweeps at work in many columns, down to
    the bottom: a seeded diabatic depth spread over the upper dozen levels
    and slope measures scaled up a hundredfold. (With the first layer as
    diabatic depth, all this slice has without a KPP boundary layer, the
    search settles within the top few levels.)"""
    gen = torch.Generator()
    gen.manual_seed(seed)
    vg = grid.vgrid
    lo, hi = 0.3 * float(vg.zw[0]), float(vg.zt[min(12, cfg.km - 1)])
    dd = lo + (hi - lo) * torch.rand(cfg.ny, cfg.nx, generator=gen,
                                     dtype=torch.float64)
    return dd.to(device=sla.device, dtype=sla.dtype), sla * 100.0


def gm_kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """The three GM kernels and the tracer kernel's mode without the
    Laplacian, each against its plain version at the GM paths' shapes, with
    times and bounds. Returns {name: record}."""
    cfg = full_config(dtype_name, "gm_full")
    dt = cfg.torch_dtype
    grid = build_grid(cfg, DEV)
    bc = grid_bc(cfg)
    tr = ts_range_of(cfg, grid)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    tmix = sample.grid_tracers(cfg, grid, SEED + 2)
    rec = {}

    # ---- slopes: T, S in; 8 slopes, 2 slope measures, N^2 out --------------
    args = (cfg, grid, bc, tr, tmix)
    slp, sla, n2 = gm_slope_cuda.slopes(*args)
    torch.cuda.synchronize()
    want = gm_slope_cuda.slopes_plain(*args)
    r = compare_slopes("gm_slope", dt, (slp, sla, n2), want,
                       true_slope_factors(grid))
    r["ms"] = time_ms(lambda: gm_slope_cuda.slopes(*args), 3, n_timed)
    b2b = time_ms_back_to_back(
        lambda: gm_slope_cuda.slopes(*args), n_timed)
    r["ms_back_to_back"] = b2b
    r["plain_ms"] = time_ms(lambda: gm_slope_cuda.slopes_plain(*args), 1, 3)
    r["bound_ms"], r["bound_by"] = bound(
        s * (13 * N + 2 * P + 19 * km) + 4 * P, N * 300, dt)
    r.update(launch_info("gm_slope", dt))
    rec["gm_slope"] = r
    del want

    # ---- chain, the main path's instance: bfre, no diagnostic columns ------
    # tmix, 8 slopes, 2 slope measures, the vertical profile in; GTK per
    # tracer and VDC_GM out; six float and three int 2-D fields
    rb = gm._rossby_radius(grid)
    tlt = gm.transition_layer(cfg, grid, gm.first_layer_depth(grid), sla, rb)
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    # the plain search between the two kernels: as this path runs it, and
    # with every level searched (host-bound loops of small launches)
    deep = searched_inputs(cfg, grid, sla, SEED + 5)
    emit({"phase": "gm_search_plain", "dtype": dtype_name,
          "ms_first_layer_depth": time_ms(lambda: gm.transition_layer(
              cfg, grid, gm.first_layer_depth(grid), sla, rb), 1, 5),
          "deepest_level_first_layer_depth": int(tlt.k_level.max()),
          "ms_searched_to_the_bottom": time_ms(lambda: gm.transition_layer(
              cfg, grid, *deep, rb), 1, 5),
          "deepest_level_searched": int(gm.transition_layer(
              cfg, grid, *deep, rb).k_level.max())})
    del deep
    args = (cfg, grid, bc, tmix, slp, sla, kv, tlt, False)
    got = gm_chain_cuda.chain(*args)[:2]
    torch.cuda.synchronize()
    want = gm_chain_cuda.chain_plain(*args)[:2]
    err_abs, err_rel, excused = compare_chain("gm_chain", dt, got, want)
    del want
    ms = time_ms(lambda: gm_chain_cuda.chain(*args), 3, n_timed)
    b2b = time_ms_back_to_back(
        lambda: gm_chain_cuda.chain(*args), n_timed)
    plain_ms = time_ms(lambda: gm_chain_cuda.chain_plain(*args), 1, 3)
    b_ms, b_by = bound(s * (N * (2 * nt + 12) + 6 * P + 8 * km) + 12 * P,
                       N * (400 + 80 * nt), dt)
    rec["gm_chain"] = {"max_abs_err": err_abs, "rel_err": err_rel,
                       "points_within_relative_band_only": excused,
                       "ms": ms, "ms_back_to_back": b2b,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by,
                       "transition_levels": sorted(
                           set(tlt.k_level.flatten().tolist())),
                       **launch_info("gm_chain", dt, nt=nt,
                                     flags=gm_chain_cuda.kernel_flags(
                                         cfg, False))}
    del slp, sla, n2, kv, tlt, got

    # ---- flux assembly: the gm_flux path's instance (cancellation: the skew
    # terms vanish and tz and the streamfunction are not read), and the skew
    # instance beside it -------------------------------------------------
    cfg_f = full_config(dtype_name, "gm_flux")
    f = sample.flux_operands(cfg_f, grid, bc, tr, tmix)
    r = {}
    for cancellation, tag, n_in in ((True, "", 2 * nt + 12),
                                    (False, "_skew", 3 * nt + 20)):
        args = (cfg_f, grid, bc) + f + (cancellation,)
        got = gm_cuda.flux_assembly(*args)
        torch.cuda.synchronize()
        want = gm_cuda.flux_assembly_plain(*args)
        err_abs, err_rel = compare("gm_flux", dt, got[:1], want[:1])
        vdc_rel = compare_vdc("gm_flux", dt, got[1], want[1])
        del got, want
        ms = time_ms(lambda: gm_cuda.flux_assembly(*args), 3, n_timed)
        b2b = time_ms_back_to_back(
            lambda: gm_cuda.flux_assembly(*args), n_timed)
        plain_ms = time_ms(lambda: gm_cuda.flux_assembly_plain(*args), 1, 3)
        b_ms, b_by = bound(s * (N * (n_in + nt + 1) + 3 * P + 3 * km)
                           + 4 * P, N * (60 + 60 * nt), dt)
        r.update({"max_abs_err" + tag: err_abs, "rel_err" + tag: err_rel,
                  "vdc_rel_err" + tag: vdc_rel, "ms" + tag: ms,
                  "ms_back_to_back" + tag: b2b, "plain_ms" + tag: plain_ms,
                  "bound_ms" + tag: b_ms,
                  "bound_by" + tag: b_by,
                  **launch_info("gm_flux", dt, tag, nt=nt,
                                cancellation=cancellation)})
    rec["gm_flux"] = r
    del f

    # ---- tracer tendency without the Laplacian: u, v, vdc (2), trcr, told
    # and the output per tracer; tmix is not read ----------------------------
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    f = random_fields(cfg, grid, gen)
    args = (cfg, grid, f["ucur"], f["vcur"], f["trcr"], f["told"], f["told"],
            f["vdc"], f["stf"], f["dh"])
    got = tracer_cuda.tracer_tendency(*args)
    torch.cuda.synchronize()
    want = tracer_cuda.tracer_tendency_plain(*args)
    err_abs, err_rel = compare("tracer_advdiff", dt, [got], [want])
    ms = time_ms(lambda: tracer_cuda.tracer_tendency(*args), 3, n_timed)
    b2b = time_ms_back_to_back(
        lambda: tracer_cuda.tracer_tendency(*args), n_timed)
    plain_ms = time_ms(lambda: tracer_cuda.tracer_tendency_plain(*args), 1, 3)
    b_ms, b_by = bound(s * (N * (4 + 2 * nt) + P * (nt + 8) + 4 * km) + 4 * P,
                       N * (30 + 35 * nt), dt)
    rec["tracer_advdiff"] = {"max_abs_err": err_abs, "rel_err": err_rel,
                             "ms": ms, "ms_back_to_back": b2b,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by,
                             **launch_info("tracer", dt, ng=nt,
                                           del2=False)}
    return rec


def gm_other_modes_phase(dtype_name: str):
    """The modes of the GM kernels that the main paths' configurations do not
    select: closed east-west boundary, the diagnostic columns, constant
    diffusivities, unequal slope limits (with the bottom-cell diffusion floor
    and the diffusivity-valued surface diffusion), a transition layer that
    the search extended, the flux assembly's skew branch and its
    anisotropic instances (both branches), the tracer kernel's rigid lid
    without the Laplacian. Each against its plain version at full size. Not
    timed."""
    worst = {}
    variants = {
        "bfre": {},
        "const_slm": dict(gm_kappa_isop_type="const",
                          gm_kappa_thic_type="const", gm_slm_b=0.25,
                          gm_ah_bolus=2.0e7, gm_ah_bkg_bottom=1.0e6,
                          gm_use_const_ah_bkg_srfbl=False),
    }
    for ew in ("cyclic", "closed"):
        base = full_config(dtype_name, "gm_full").with_(ew_boundary=ew)
        dt = base.torch_dtype
        grid = build_grid(base, DEV)
        bc = grid_bc(base)
        tr = ts_range_of(base, grid)
        tmix = sample.grid_tracers(base, grid, SEED + 4)
        got = gm_slope_cuda.slopes(base, grid, bc, tr, tmix)
        torch.cuda.synchronize()
        want = gm_slope_cuda.slopes_plain(base, grid, bc, tr, tmix)
        r = compare_slopes("gm_slope", dt, got, want,
                           true_slope_factors(grid))
        worst[f"slope_{ew}"] = r["rel_err"]
        worst[f"slope_{ew}_steep_points_passed"] = r["steep_points_passed"]
        slp, sla, n2 = got
        del want
        tlt = gm.transition_layer(
            base, grid, *searched_inputs(base, grid, sla, SEED + 5),
            gm._rossby_radius(grid))
        for label, over in variants.items():
            cfg = base.with_(**over)
            kv = (gm.kappa_vertical_bfre(cfg, grid, tr, tmix,
                                         tlt.interior_depth, n2=n2)
                  if cfg.gm_kappa_isop_type == "bfre"
                  else torch.ones_like(n2))
            args = (cfg, grid, bc, tmix, slp, sla, kv, tlt, True)
            got = gm_chain_cuda.chain(*args)
            torch.cuda.synchronize()
            want = gm_chain_cuda.chain_plain(*args)
            worst[f"chain_diags_searched_{label}_{ew}"] = compare_chain(
                "gm_chain", dt, (got[0], got[1], *got[2]),
                (want[0], want[1], *want[2]))[1]
            del got, want, kv
        worst[f"chain_searched_levels_{ew}"] = len(
            set(tlt.k_level.flatten().tolist()))
        del slp, sla, n2, tlt
        if ew == "cyclic":
            continue  # timed in the kernel phase
        cfg_f = full_config(dtype_name, "gm_flux").with_(ew_boundary=ew)
        f = sample.flux_operands(cfg_f, grid, bc, tr, tmix)
        ky = aniso_kisop_y(f[7])
        for cancellation, aniso in itertools.product((True, False),
                                                     (False, True)):
            args = (cfg_f, grid, bc) + f + (cancellation,)
            kw = {"kisop_y": ky} if aniso else {}
            reset_counts()
            got = gm_cuda.flux_assembly(*args, **kw)
            torch.cuda.synchronize()
            if gm_cuda.launches_aniso != int(aniso):
                raise AssertionError("gm_flux: the anisotropic instance "
                                     "was not the one launched")
            want = gm_cuda.flux_assembly_plain(*args, **kw)
            branch = (("cancel" if cancellation else "skew")
                      + ("_aniso" if aniso else ""))
            worst[f"flux_{branch}_{ew}"] = compare("gm_flux", dt, got[:1],
                                                   want[:1])[1]
            worst[f"flux_{branch}_{ew}_vdc"] = compare_vdc(
                "gm_flux", dt, got[1], want[1])
            del got, want
        del f, ky
    for ew in ("cyclic", "closed"):
        cfg = full_config(dtype_name, "gm_full").with_(ew_boundary=ew,
                                                       sfc_layer="rigid")
        grid = build_grid(cfg, DEV)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED + 6)
        f = random_fields(cfg, grid, gen)
        args = (cfg, grid, f["ucur"], f["vcur"], f["trcr"], f["tmix"],
                f["told"], f["vdc"], f["stf"], f["dh"])
        got = tracer_cuda.tracer_tendency(*args)
        torch.cuda.synchronize()
        want = tracer_cuda.tracer_tendency_plain(*args)
        worst[f"tracer_advdiff_{ew}_rigid"] = compare(
            "tracer_advdiff", cfg.torch_dtype, [got], [want])[1]
    dt = full_config(dtype_name).torch_dtype
    emit({"phase": "gm_other_modes", "dtype": dtype_name,
          "rel_err_of_scale": worst,
          "band": {"slope": SLOPE_BAND[dt], "n2": N2_BAND[dt],
                   "chain": [BAND[("gm_chain", dt)], GM_CHAIN_REL[dt]],
                   "flux": BAND[("gm_flux", dt)],
                   "flux_vdc_rtol": GM_VDC_RTOL[dt],
                   "tracer_advdiff": BAND[("tracer_advdiff", dt)]}})


def ragged_config(dtype_name: str, km: int, ew: str):
    """The gm_full configuration on the RAGGED grid with km levels (evenly
    spaced where the internal vertical grid cannot take so few)."""
    extra = {"vert_grid": "uniform"} if km == 1 else {}
    return get_config("test", nx=RAGGED[0], ny=RAGGED[1], km=km, vmix="rich",
                      dtype=dtype_name,
                      solver=SolverConfig(solve_dtype="float64"),
                      ew_boundary=ew, **GM_FULL, **extra)


def ragged_phase(dtype_name: str):
    """The six kernels that stage in shared memory against their plain
    versions where the tiles do not divide the domain: the RAGGED horizontal
    size, E-W cyclic and closed, at RAGGED_KM levels (one level, and the
    thomas kernel's bound). thomas for 1 to 4 right-hand sides and 6 (two
    launches); the
    slope kernel; the transition-layer search from a deep diabatic depth;
    the chain kernel in its sixteen template instances (bfre or const
    kappa, diagnostic columns or not, equal or unequal slope limits, the
    submesoscale fold-in or not), each with the constant and the
    diffusivity-valued surface diffusion (``hd_const``); the flux assembly
    in both branches for 1, 2, 3 and 16 tracers (all but 2 take the narrow
    tile; tracers beyond the configuration's two get noisy copies of its
    differences); the tracer
    kernel with centered and upwind3 advection, with and without the
    Laplacian, for 1, 2, 3 and 5 tracers (3 and 5 are two and three
    launches, over the kernel's group cap; the wrapper gets random fields),
    varthick and rigid lid; the momentum kernel with the leapfrog and the
    Euler Coriolis weights. Bands as at full size. Not timed."""
    worst = {}
    for km, ew in itertools.product(RAGGED_KM, ("cyclic", "closed")):
        base = ragged_config(dtype_name, km, ew)
        dt = base.torch_dtype
        grid = build_grid(base, DEV)
        if ew == "cyclic":  # the sweep reads no neighbour
            gen = torch.Generator(device=DEV)
            gen.manual_seed(SEED + 8)
            f = random_fields(base, grid, gen)
            hfac, h1, a = thomas_operands(base, grid, f)
            # every count a launch takes, and 6 (two launches of 3)
            for nr in (*range(1, tridiag_cuda.MAX_RHS + 1), 6):
                rhs = torch.randn(nr, km, *RAGGED[::-1], generator=gen,
                                  device=DEV, dtype=dt) * grid.kmask_t.to(dt)
                args = (hfac, h1, grid.KMT, a, rhs)
                got = tridiag_cuda.thomas(*args)
                torch.cuda.synchronize()
                want = tridiag_cuda.thomas_plain(*args)
                worst[f"thomas_km{km}_nr{nr}"] = compare("thomas", dt, [got],
                                                         [want])[1]
        bc = grid_bc(base)
        tr = ts_range_of(base, grid)
        tmix = sample.grid_tracers(base, grid, SEED + 9)
        slp, sla, n2 = gm_slope_cuda.slopes_plain(base, grid, bc, tr, tmix)
        got = gm_slope_cuda.slopes(base, grid, bc, tr, tmix)
        torch.cuda.synchronize()
        r = compare_slopes("gm_slope", dt, got, (slp, sla, n2),
                           true_slope_factors(grid))
        worst[f"slope_km{km}_{ew}"] = r["rel_err"]
        worst[f"slope_km{km}_{ew}_steep_points_passed"] = r[
            "steep_points_passed"]
        del got
        cfg_f = base.with_(gm_transition_layer=False,
                           gm_kappa_isop_type="const",
                           gm_kappa_thic_type="const")
        f = sample.flux_operands(cfg_f, grid, bc, tr, tmix,
                                 levels=(min(2, km - 1), min(5, km - 1)))
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED + 11)
        for nt, cancellation in itertools.product((1, 2, 3, 16),
                                                  (True, False)):
            diffs = [torch.cat([t[:nt]] + [
                (t[n % 2] * (1.0 + 0.1 * torch.randn(
                    t.shape[1:], generator=gen, device=DEV, dtype=dt)))[None]
                for n in range(2, nt)]).contiguous() for t in f[:3]]
            args = (cfg_f, grid, bc, *diffs, *f[3:], cancellation)
            got = gm_cuda.flux_assembly(*args)
            torch.cuda.synchronize()
            want = gm_cuda.flux_assembly_plain(*args)
            branch = "cancel" if cancellation else "skew"
            key = f"flux_{branch}_km{km}_{ew}_nt{nt}"
            worst[key] = compare("gm_flux", dt, got[:1], want[:1])[1]
            worst[key + "_vdc"] = compare_vdc("gm_flux", dt, got[1], want[1])
            del got, want, diffs
        del f
        deep = searched_inputs(base, grid, sla, SEED + 5)
        tlt = gm.transition_layer(base, grid, *deep, gm._rossby_radius(grid))
        worst[f"tlt_search_km{km}_{ew}"] = compare_search(
            "gm_tlt", dt, gm_tlt_cuda.transition_layer(
                base, grid, *deep, gm._rossby_radius(grid)), tlt)[1]
        sm = submeso.amplitudes(base, grid, bc, tr, tmix,
                                mixed_layer(deep[0], SEED + 19))
        for bfre, diags, same, hd_const, with_sm in itertools.product(
                (True, False), repeat=5):
            # a surface diffusion apart from the isopycnal diffusivity, so
            # that hd_const shows
            over = {"gm_use_const_ah_bkg_srfbl": hd_const,
                    "gm_ah_bkg_srfbl": 1.5e7}
            if not bfre:
                over.update(gm_kappa_isop_type="const",
                            gm_kappa_thic_type="const")
            if not same:
                over.update(gm_slm_b=0.25, gm_ah_bolus=2.0e7,
                            gm_ah_bkg_bottom=1.0e6)
            cfg = base.with_(**over)
            kv = (gm.kappa_vertical_bfre(cfg, grid, tr, tmix,
                                         tlt.interior_depth, n2=n2)
                  if bfre else torch.ones_like(n2))
            args = (cfg, grid, bc, tmix, slp, sla, kv, tlt, diags,
                    sm if with_sm else None)
            got = gm_chain_cuda.chain(*args)
            torch.cuda.synchronize()
            want = gm_chain_cuda.chain_plain(*args)
            outs = [(g, w) for g, w in zip(got[:2], want[:2])]
            if diags:
                outs += list(zip(got[2], want[2]))
            flags = gm_chain_cuda.kernel_flags(cfg, diags, with_sm)
            key = f"chain_km{km}_{ew}_flags{flags}_hd{int(hd_const)}"
            worst[key] = compare_chain("gm_chain", dt, *zip(*outs))[1]
        del slp, sla, n2, tlt, tmix, sm

        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED + 10)
        f = random_fields(base, grid, gen)
        mt = grid.kmask_t.to(dt)
        for adv, del2, sfc, nt in itertools.product(
                ("centered", "upwind3"), (True, False),
                ("varthick", "rigid"), (1, 2, 3, 5)):
            cfg = base.with_(hmix_tracer="del2" if del2 else "gm",
                             sfc_layer=sfc, tadvect=adv)
            trc = [torch.randn(nt, km, *RAGGED[::-1], generator=gen,
                               device=DEV, dtype=dt) * mt for _ in range(3)]
            stf = torch.randn(nt, *RAGGED[::-1], generator=gen, device=DEV,
                              dtype=dt) * mt[0]
            args = (cfg, grid, f["ucur"], f["vcur"], *trc, f["vdc"], stf,
                    f["dh"])
            got = tracer_cuda.tracer_tendency(*args)
            torch.cuda.synchronize()
            want = tracer_cuda.tracer_tendency_plain(*args)
            name = "tracer" if del2 else "tracer_advdiff"
            worst[f"{name}_{adv}_km{km}_{ew}_{sfc}_nt{nt}"] = compare(
                name, dt, [got], [want])[1]
        for leapfrog in (True, False):
            rhoavg = pgrad.rho_average(base, grid, *f["rho"], leapfrog)
            wc, wo = clinic_cuda.coriolis_weights(base, leapfrog)
            um, vm = ((f["uold"], f["vold"]) if leapfrog
                      else (f["ucur"], f["vcur"]))
            args = (base, grid, f["ucur"], f["vcur"], f["uold"], f["vold"],
                    um, vm, rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
            got = clinic_cuda.clinic_rhs_fields(*args)
            torch.cuda.synchronize()
            want = clinic_cuda.clinic_rhs_plain(*args)
            step = "leapfrog" if leapfrog else "euler"
            worst[f"clinic_km{km}_{ew}_{step}"] = compare("clinic", dt, got,
                                                          want)[1]
    emit({"phase": "ragged", "dtype": dtype_name, "dims": list(RAGGED),
          "km": list(RAGGED_KM), "rel_err_of_scale": worst,
          "band": {"thomas": BAND[("thomas", dt)],
                   "slope": SLOPE_BAND[dt], "n2": N2_BAND[dt],
                   "search": BAND[("gm_tlt", dt)],
                   "chain": [BAND[("gm_chain", dt)], GM_CHAIN_REL[dt]],
                   "flux": BAND[("gm_flux", dt)],
                   "flux_vdc_rtol": GM_VDC_RTOL[dt],
                   "tracer": BAND[("tracer", dt)],
                   "tracer_advdiff": BAND[("tracer_advdiff", dt)],
                   "clinic": BAND[("clinic", dt)]}})


def other_modes_phase(dtype_name: str):
    """The modes of the tracer and momentum kernels that the main path's
    configuration does not select but the kernels carry (closed east-west
    boundary, rigid lid, Euler-step Coriolis weights), each against its plain
    version at full size. Not timed."""
    worst = {}
    for ew in ("cyclic", "closed"):
        for sfc in ("varthick", "rigid"):
            cfg = full_config(dtype_name).with_(ew_boundary=ew, sfc_layer=sfc)
            dt = cfg.torch_dtype
            grid = build_grid(cfg, DEV)
            gen = torch.Generator(device=DEV)
            gen.manual_seed(SEED + 1)
            f = random_fields(cfg, grid, gen)
            args = (cfg, grid, f["ucur"], f["vcur"], f["trcr"], f["tmix"],
                    f["told"], f["vdc"], f["stf"], f["dh"])
            got = tracer_cuda.tracer_tendency(*args)
            torch.cuda.synchronize()
            want = tracer_cuda.tracer_tendency_plain(*args)
            worst[f"tracer_{ew}_{sfc}"] = compare("tracer", dt, [got],
                                                  [want])[1]
            if sfc == "rigid":
                continue  # the momentum kernel does not read sfc_layer
            for leapfrog in (True, False):
                rhoavg = pgrad.rho_average(cfg, grid, *f["rho"], leapfrog)
                wc, wo = clinic_cuda.coriolis_weights(cfg, leapfrog)
                um, vm = ((f["uold"], f["vold"]) if leapfrog
                          else (f["ucur"], f["vcur"]))
                args = (cfg, grid, f["ucur"], f["vcur"], f["uold"],
                        f["vold"], um, vm, rhoavg, f["vvc"], f["smf"],
                        f["dhu"], wc, wo)
                got = clinic_cuda.clinic_rhs_fields(*args)
                torch.cuda.synchronize()
                want = clinic_cuda.clinic_rhs_plain(*args)
                step = "leapfrog" if leapfrog else "euler"
                worst[f"clinic_{ew}_{step}"] = compare("clinic", dt, got,
                                                       want)[1]
    emit({"phase": "other_modes", "dtype": dtype_name,
          "rel_err_of_scale": worst,
          "band": {"tracer": BAND[("tracer", cfg.torch_dtype)],
                   "clinic": BAND[("clinic", cfg.torch_dtype)]}})


def fold_case(cfg):
    """The grid of ``cfg`` on the device with the seeded bottom that has
    ocean across the tripole fold (``sample.fold_grid``), its boundary and
    the equation of state's T/S range."""
    grid = sample.fold_grid(cfg, build_grid(cfg, DEV), SEED + 11)
    if not bool((grid.KMT[-2:] > 0).any() and (grid.KMU[-1] > 0).any()):
        raise AssertionError("the fold bottom has no ocean in its top rows")
    return grid, grid_bc(cfg), ts_range_of(cfg, grid)


def fold_kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """The kernel modes of the prod_dyn path (the tracer kernel with upwind3
    and the fold, the momentum kernel without the Laplacian and with the
    fold, the slopes and the chain on the fold), each against its plain
    version at the path's shapes on the fold bottom, with times and bounds;
    the tracer kernel with the top U row's DXU opened
    (``sample.open_top_dxu``), also as prod_full's call of five tracers
    (three launches), and the chain with the top row's north faces opened
    (``sample.open_top_face``), each with the fold's share of the top row
    held far above the band. Returns {name: record}."""
    cfg = full_config(dtype_name, "prod_dyn")
    dt = cfg.torch_dtype
    grid, bc, tr = fold_case(cfg)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 12)
    f = random_fields(cfg, grid, gen)
    rec = {}

    def timed(fn, plain, nbytes, flops, **info):
        r = {"ms": time_ms(fn, 3, n_timed),
             "ms_back_to_back": time_ms_back_to_back(fn, n_timed),
             "plain_ms": time_ms(plain, 1, 3)}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dt)
        r.update(info)
        return r

    # ---- tracer: upwind3 on the fold, without the Laplacian, with the top
    # U row's DXU opened so that flux crosses the fold: u, v, vdc (2), trcr,
    # told and the output per tracer; 12 coefficient planes and the 2-D
    # fields. prod_dyn's two tracers (one launch) and prod_full's five
    # (three launches: 2, 2, 1)
    opened = sample.open_top_dxu(grid)
    c5 = cfg.with_(passive_tracers=("iage", "cfc"), nt=5)
    f5 = random_fields(c5, grid, gen)
    for key, c, g in (("tracer_upwind3", cfg, f),
                      ("tracer_upwind3_nt5", c5, f5)):
        n = c.nt
        args = (c, opened, g["ucur"], g["vcur"], g["trcr"], g["told"],
                g["told"], g["vdc"], g["stf"], g["dh"])
        got = tracer_cuda.tracer_tendency(*args)
        torch.cuda.synchronize()
        want = tracer_cuda.tracer_tendency_plain(*args)
        err_abs, err_rel = compare("tracer", dt, [got], [want])
        top = compare("tracer", dt, [got[..., -2:, :]],
                      [want[..., -2:, :]])[1]
        fold_share = tracer_fold_share(key, dt, args, want)
        del got, want
        rec[key] = timed(
            lambda: tracer_cuda.tracer_tendency(*args),
            lambda: tracer_cuda.tracer_tendency_plain(*args),
            s * (N * (4 + 2 * n) + P * (n + 8 + 12) + 10 * km) + 4 * P,
            N * (40 + 120 * n), max_abs_err=err_abs, rel_err=err_rel,
            rel_err_top_rows=top, fold_share_of_top_row=fold_share,
            groups=tracer_cuda.tracer_groups(n),
            **launch_info("tracer", dt, ng=min(n, tracer_cuda.MAX_GROUP),
                          del2=False, upwind3=True, fold=True))
    del f5

    # ---- tracer: centered advection on the fold (the staged tile's FOLD
    # instances), a mode no path runs: held and timed on its own line, with
    # the bytes of the upwind3 case less its 12 coefficient planes
    cc = cfg.with_(tadvect="centered")
    args = (cc, opened, f["ucur"], f["vcur"], f["trcr"], f["told"],
            f["told"], f["vdc"], f["stf"], f["dh"])
    got = tracer_cuda.tracer_tendency(*args)
    torch.cuda.synchronize()
    want = tracer_cuda.tracer_tendency_plain(*args)
    err_abs, err_rel = compare("tracer", dt, [got], [want])
    del got, want
    emit({"phase": "tracer_centered_fold", "dtype": dtype_name,
          **timed(lambda: tracer_cuda.tracer_tendency(*args),
                  lambda: tracer_cuda.tracer_tendency_plain(*args),
                  s * (N * (4 + 2 * nt) + P * (nt + 8) + 10 * km) + 4 * P,
                  N * (40 + 60 * nt), max_abs_err=err_abs,
                  rel_err=err_rel,
                  **launch_info("tracer", dt, ng=min(nt, tracer_cuda.MAX_GROUP),
                                del2=False, upwind3=False, fold=True))})

    # ---- momentum forcing without the Laplacian, on the fold: u, v at two
    # times, the density, the viscosity in (um, vm are not read)
    rhoavg = pgrad.rho_average(cfg, grid, f["rho"][0], f["rho"][1],
                               f["rho"][2], True)
    wc, wo = clinic_cuda.coriolis_weights(cfg, True)
    args = (cfg, grid, f["ucur"], f["vcur"], f["uold"], f["vold"], f["uold"],
            f["vold"], rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
    got = clinic_cuda.clinic_rhs_fields(*args)
    torch.cuda.synchronize()
    want = clinic_cuda.clinic_rhs_plain(*args)
    err_abs, err_rel = compare("clinic", dt, got, want)
    top = compare("clinic", dt, [g[..., -2:, :] for g in got],
                  [w[..., -2:, :] for w in want])[1]
    del got, want
    wet = float(grid.kmask_u.to(torch.float64).mean())
    rec["clinic_aniso"] = timed(
        lambda: clinic_cuda.clinic_rhs_fields(*args),
        lambda: clinic_cuda.clinic_rhs_plain(*args),
        s * (N * (6 * wet + 2) + P * (10 + 2 + 1 + 2) + 5 * km) + 4 * P,
        N * wet * 150, max_abs_err=err_abs, rel_err=err_rel,
        rel_err_top_rows=top, ocean_fraction_u=wet,
        **launch_info("clinic", dt, hdiffu=False))

    # ---- slopes on the fold
    tmix = sample.grid_tracers(cfg, grid, SEED + 13)
    args = (cfg, grid, bc, tr, tmix)
    slp, sla, n2 = gm_slope_cuda.slopes(*args)
    torch.cuda.synchronize()
    want = gm_slope_cuda.slopes_plain(*args)
    r = compare_slopes("gm_slope", dt, (slp, sla, n2), want,
                       true_slope_factors(grid))
    del want
    rec["gm_slope_tripole"] = timed(
        lambda: gm_slope_cuda.slopes(*args),
        lambda: gm_slope_cuda.slopes_plain(*args),
        s * (13 * N + 2 * P + 19 * km) + 4 * P, N * 300, **r,
        **launch_info("gm_slope", dt))

    # ---- chain on the fold: the path's instance (bfre, no diagnostics),
    # with the top row's north faces opened so that flux crosses the fold
    tlt = gm.transition_layer(cfg, grid, gm.first_layer_depth(grid), sla,
                              gm._rossby_radius(grid))
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    args = (cfg, sample.open_top_face(grid), bc, tmix, slp, sla, kv, tlt,
            False)
    got = gm_chain_cuda.chain(*args)[:2]
    torch.cuda.synchronize()
    want = gm_chain_cuda.chain_plain(*args)[:2]
    err_abs, err_rel, excused = compare_chain("gm_chain", dt, got, want)
    top = compare_chain("gm_chain", dt, [g[..., -2:, :] for g in got],
                        [w[..., -2:, :] for w in want])[1]
    fold_share = chain_fold_share("gm_chain_tripole", dt, cfg, args, want[0])
    del got, want
    rec["gm_chain_tripole"] = timed(
        lambda: gm_chain_cuda.chain(*args),
        lambda: gm_chain_cuda.chain_plain(*args),
        s * (N * (2 * nt + 12) + 6 * P + 8 * km) + 12 * P,
        N * (400 + 80 * nt), max_abs_err=err_abs, rel_err=err_rel,
        rel_err_top_rows=top, points_within_relative_band_only=excused,
        fold_share_of_top_row=fold_share,
        **launch_info("gm_chain", dt, nt=nt,
                      flags=gm_chain_cuda.kernel_flags(cfg, False)))
    return rec


def fold_ragged_phase(dtype_name: str):
    """The tripole kernel modes on the fold bottom where the tiles do not
    divide the domain (the RAGGED size; the tripole ghost rows then lie
    inside a tile), E-W cyclic and closed: the tracer kernel with upwind3
    and centered advection, with and without the Laplacian, for 1, 2 and 5
    tracers, with the top U row's DXU opened (``sample.open_top_dxu``) and
    its top rows held apart; the chain with and without the submesoscale
    fold-in and the transition-layer search from a deep diabatic depth
    among them, and the momentum kernel with the Laplacian on the fold too;
    with the top row's north faces opened (``sample.open_top_face``) the
    chain again and the flux assembly's tripole row for 2 and 5 tracers in
    both branches. Not timed."""
    worst = {}
    for ew, km, vert in (("cyclic", 61, "internal"),
                         ("closed", 13, "uniform")):
        cfg = full_config(dtype_name, "prod_dyn").with_(
            nx=RAGGED[0], ny=RAGGED[1], km=km, ew_boundary=ew,
            vert_grid=vert)
        dt = cfg.torch_dtype
        grid, bc, tr = fold_case(cfg)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED + 14)
        f = random_fields(cfg, grid, gen)
        mt = grid.kmask_t.to(dt)
        opened = sample.open_top_dxu(grid)
        for adv, del2, nt in itertools.product(("upwind3", "centered"),
                                               (False, True), (1, 2, 5)):
            c = cfg.with_(tadvect=adv, hmix_tracer="del2" if del2 else "gm")
            trc = [torch.randn(nt, km, *RAGGED[::-1], generator=gen,
                               device=DEV, dtype=dt) * mt for _ in range(3)]
            stf = torch.randn(nt, *RAGGED[::-1], generator=gen, device=DEV,
                              dtype=dt) * mt[0]
            args = (c, opened, f["ucur"], f["vcur"], *trc, f["vdc"], stf,
                    f["dh"])
            got = tracer_cuda.tracer_tendency(*args)
            torch.cuda.synchronize()
            want = tracer_cuda.tracer_tendency_plain(*args)
            key = f"tracer_{adv}_{ew}_del2{int(del2)}_nt{nt}"
            worst[key] = compare("tracer", dt, [got], [want])[1]
            worst[key + "_top_rows"] = compare(
                "tracer", dt, [got[..., -2:, :]], [want[..., -2:, :]])[1]
            del got, want, trc
        rhoavg = pgrad.rho_average(cfg, grid, *f["rho"], True)
        for hm in ("aniso", "del2"):
            c = cfg.with_(hmix_momentum=hm)
            args = (c, grid, f["ucur"], f["vcur"], f["uold"], f["vold"],
                    f["uold"], f["vold"], rhoavg, f["vvc"], f["smf"],
                    f["dhu"], 0.3, 0.7)
            worst[f"clinic_{hm}_{ew}"] = compare(
                "clinic", dt, clinic_cuda.clinic_rhs_fields(*args),
                clinic_cuda.clinic_rhs_plain(*args))[1]
        tmix = sample.grid_tracers(cfg, grid, SEED + 15)
        args = (cfg, grid, bc, tr, tmix)
        got = gm_slope_cuda.slopes(*args)
        r = compare_slopes("gm_slope", dt, got,
                           gm_slope_cuda.slopes_plain(*args),
                           true_slope_factors(grid))
        worst[f"gm_slope_{ew}"] = r["rel_err"]
        slp, sla, n2 = got
        rb = gm._rossby_radius(grid)
        deep = searched_inputs(cfg, grid, sla, SEED + 5)
        tlt = gm.transition_layer(cfg, grid, *deep, rb)
        worst[f"gm_tlt_{ew}"] = compare_search(
            "gm_tlt", dt, gm_tlt_cuda.transition_layer(cfg, grid, *deep, rb),
            tlt)[1]
        kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                    n2=n2)
        sm = submeso.amplitudes(cfg, grid, bc, tr, tmix,
                                mixed_layer(deep[0], SEED + 19))
        for with_sm in (False, True):
            args = (cfg, grid, bc, tmix, slp, sla, kv, tlt, True,
                    sm if with_sm else None)
            worst[f"gm_chain_{ew}" + ("_sm" if with_sm else "")] = \
                compare_chain("gm_chain", dt, gm_chain_cuda.chain(*args),
                              gm_chain_cuda.chain_plain(*args))[1]
        # with the top row's north faces opened, flux crosses the fold:
        # the chain, and the flux assembly's tripole row for 2 and 5
        # tracers in both branches
        opened = sample.open_top_face(grid)
        args = (cfg, opened, bc, tmix, slp, sla, kv, tlt, True, sm)
        worst[f"gm_chain_{ew}_sm_open_top"] = compare_chain(
            "gm_chain", dt, gm_chain_cuda.chain(*args),
            gm_chain_cuda.chain_plain(*args))[1]
        del slp, sla, n2, kv, sm
        c5 = cfg.with_(passive_tracers=("iage", "cfc"), nt=5)
        tm5 = sample.grid_tracers(c5, opened, SEED + 21)
        for nt, cancellation in itertools.product((2, 5), (True, False)):
            c = c5 if nt == 5 else cfg
            f = sample.flux_operands(c, opened, bc, tr, tm5[:nt],
                                     levels=(2, 5))
            args = (c, opened, bc, *f, cancellation)
            got = gm_cuda.flux_assembly(*args)
            torch.cuda.synchronize()
            want = gm_cuda.flux_assembly_plain(*args)
            key = (f"gm_flux_{ew}_nt{nt}_"
                   + ("cancel" if cancellation else "skew"))
            worst[key] = compare("gm_flux", dt, got[:1], want[:1])[1]
            worst[key + "_vdc"] = compare_vdc("gm_flux", dt, got[1], want[1])
            del got, want, f
    emit({"phase": "fold_ragged", "dtype": dtype_name,
          "dims": [RAGGED[0], RAGGED[1]], "rel_err_of_scale": worst})


def kpp_state(cfg, grid, tmix, seed: int):
    """(KPP's output, its statics, its other inputs) for the tracers
    ``tmix`` under seeded velocities of 5 cm/s, wind stress, shortwave and a
    surface heat flux that cools 40 % of the points: boundary-layer and
    mixed-layer depths of a production shape for the GM kernels."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    dt, km, ny, nx = cfg.torch_dtype, cfg.km, cfg.ny, cfg.nx
    mt, mu = grid.kmask_t.to(dt), grid.kmask_u.to(dt)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV, dtype=dt)

    heat = 5.0e-4 * randn(ny, nx).abs()
    cool = torch.rand(ny, nx, generator=gen, device=DEV, dtype=dt) < 0.4
    args = dict(
        umix=5.0 * randn(km, ny, nx) * mu, vmix_=5.0 * randn(km, ny, nx) * mu,
        stf=torch.stack([torch.where(cool, -heat, 0.2 * heat),
                         torch.zeros_like(heat)]) * mt[0],
        shf_qsw=2.0e-4 * randn(ny, nx).abs() * mt[0],
        smft=0.5 * randn(2, ny, nx) * mt[0])
    args["chl"] = torch.full_like(args["shf_qsw"], cfg.chl_const)
    if cfg.lniw_mixing:  # the current velocities of the 'blke' NIW energy
        args.update(ucur=5.0 * randn(km, ny, nx) * mu,
                    vcur=5.0 * randn(km, ny, nx) * mu)
    st = kpp.build_statics(cfg, grid)

    def run():
        return kpp.kpp_coeffs(cfg, grid, grid_bc(cfg), st, tmix,
                              convect_diff=cfg.convect_diff,
                              convect_visc=cfg.convect_visc, **args)
    return run(), run


def pbc_share(name, dtype, got, full):
    """How far a kernel's output under partial bottom cells lies from the
    same kernel's on full cells, over its scale: held far above the band,
    so that the check against the plain version sees the bottom cells."""
    share = max(float((g - f).abs().max()) / (float(g.abs().max()) or 1.0)
                for g, f in zip(got, full))
    if not share > 100.0 * BAND[(name, dtype)]:
        raise AssertionError(f"{name} {dtype}: partial bottom cells moved "
                             f"the output by {share:.2e} only; the check "
                             f"cannot see them")
    return share


def full_cells(grid):
    """``grid`` without its partial-bottom-cell fields."""
    return grid.replace(DZT=None, DZU=None, DZBT=None, DZBU=None)


def pbc_kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """The partial-bottom-cell (PBC) instances of thomas, the tracer kernel
    and the momentum kernel against their plain versions at full size, on
    stepped bottoms whose every ocean column ends in a seeded partial cell
    (``sample.with_bottom_cells``; the internal topography alone puts every
    bottom at the last level): prod_pbc's instances timed (thomas for the
    tracers' two right-hand sides, upwind3 on the fold without the
    Laplacian, the momentum kernel on the fold without the friction), every
    other instance held untimed (thomas for 1, 3, 4 right-hand sides;
    centered advection with and without the Laplacian, closed and on the
    fold; upwind3 with the Laplacian; the momentum kernel with the friction,
    closed and on the fold, and fed u - TSU), each output's distance from
    the full-cell kernel's held far above its band. Returns {name:
    record}."""
    rec, worst = {}, {}
    # ---- closed, the dynamical core's grid on a stepped bottom
    cfg = full_config(dtype_name)
    dt = cfg.torch_dtype
    grid = sample.with_bottom_cells(
        cfg, sample.fold_grid(cfg, build_grid(cfg, DEV), SEED + 41),
        SEED + 42)
    km, ny, nx = cfg.km, cfg.ny, cfg.nx
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 43)
    f = random_fields(cfg, grid, gen)

    def timed(fn, plain, nbytes, flops, **info):
        r = {"ms": time_ms(fn, 3, n_timed),
             "ms_back_to_back": time_ms_back_to_back(fn, n_timed),
             "plain_ms": time_ms(plain, 1, 3)}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dt)
        r["bound_share"] = r["bound_ms"] / r["ms_back_to_back"]
        r.update(info)
        return r

    # ---- thomas: the tracer solve's operands on the partial cells, under
    # the convective diffusivity (1e4 cm^2/s, a thousand times
    # random_fields'), where the coupling is as large as the diagonal and
    # the bottom level's thickness reaches the solution
    c2dt = torch.full((km,), 2.0 * cfg.time.dtt, dtype=dt, device=DEV)
    hfac, h1, hbot = tridiag._diagonal(grid.vgrid.dz, c2dt, grid.KMT,
                                       grid.DZBT)
    h1 = (h1 + f["psurf"] / (const.GRAV * c2dt[0])).contiguous()
    a = tridiag._coupling(grid.vgrid.dz, grid.vgrid.dzwr,
                          1.0e3 * f["vdc"][1], cfg.aidif, grid.KMT,
                          grid.DZBT)
    for nr in (2, 1, 3, 4):
        rhs = torch.randn(nr, km, ny, nx, generator=gen, device=DEV,
                          dtype=dt) * grid.kmask_t.to(dt)
        args = (hfac, h1, grid.KMT, a, rhs, hbot)
        got = tridiag_cuda.thomas(*args)
        torch.cuda.synchronize()
        want = tridiag_cuda.thomas_plain(*args)
        err_abs, err_rel = compare("thomas", dt, [got], [want])
        share = pbc_share("thomas", dt, [got],
                          [tridiag_cuda.thomas(*args[:5])])
        del got, want
        if nr != 2:
            worst[f"thomas_nr{nr}"] = err_rel
            continue
        rec["thomas_pbc"] = timed(
            lambda: tridiag_cuda.thomas(*args),
            lambda: tridiag_cuda.thomas_plain(*args),
            s * (N * (1 + 2 * nr) + 2 * P + km) + 4 * P, N * (8 + 5 * nr),
            max_abs_err=err_abs, rel_err=err_rel, pbc_share=share,
            **launch_info("thomas", dt, nr=nr, km=km, pbc=True))

    # ---- centered advection with and without the Laplacian, closed
    for hmix_tracer in ("del2", "del4"):
        c = cfg.with_(hmix_tracer=hmix_tracer)
        args = (c, grid, f["ucur"], f["vcur"], f["trcr"], f["tmix"],
                f["told"], f["vdc"], f["stf"], f["dh"])
        got = tracer_cuda.tracer_tendency(*args)
        torch.cuda.synchronize()
        want = tracer_cuda.tracer_tendency_plain(*args)
        key = f"tracer_centered_{hmix_tracer}_closed"
        worst[key] = compare("tracer", dt, [got], [want])[1]
        worst[key + "_pbc_share"] = pbc_share(
            "tracer", dt, [got], [tracer_cuda.tracer_tendency(
                c, full_cells(grid), *args[2:])])
        del got, want

    # ---- the momentum kernel with the friction, closed, and fed u - TSU
    rhoavg = pgrad.rho_average(cfg, grid, *f["rho"], True)
    wc, wo = clinic_cuda.coriolis_weights(cfg, True)
    tcfg = cfg.with_(ltopostress=True)
    tgrid = grid.replace(**dict(zip(("TSU", "TSV"), (
        torch.as_tensor(x, dtype=dt, device=DEV) for x in build_topostress(
            tcfg, *(getattr(grid, n).double().cpu().numpy() for n in (
                "HT", "KMT", "KMU", "TLAT", "FCORT", "DXUR", "DYUR",
                "HUR")))))))
    for key, c, g in (("clinic_del2_closed", cfg, grid),
                      ("clinic_topostress_closed", tcfg, tgrid)):
        um, vm = hmix.topostress_relative(c, g, f["uold"], f["vold"])
        args = (c, g, f["ucur"], f["vcur"], f["uold"], f["vold"], um, vm,
                rhoavg, f["vvc"], f["smf"], f["dhu"], wc, wo)
        got = clinic_cuda.clinic_rhs_fields(*args)
        torch.cuda.synchronize()
        want = clinic_cuda.clinic_rhs_plain(*args)
        worst[key] = compare("clinic", dt, got, want)[1]
        worst[key + "_pbc_share"] = pbc_share(
            "clinic", dt, got, clinic_cuda.clinic_rhs_fields(
                c, full_cells(g), *args[2:]))
        del got, want
    del f, grid, tgrid

    # ---- on the fold: prod_pbc's configuration and its stepped bottom
    cfg = full_config(dtype_name, "prod_pbc")
    grid, _, _ = fold_case(cfg)
    grid = sample.with_bottom_cells(cfg, grid, SEED + 44)
    opened = sample.open_top_dxu(grid)
    gen.manual_seed(SEED + 45)
    f = random_fields(cfg, grid, gen)
    nt = cfg.nt
    for key, c in (("tracer_upwind3_pbc", cfg),
                   ("tracer_upwind3_del2_fold", cfg.with_(hmix_tracer="del2")),
                   ("tracer_centered_del2_fold",
                    cfg.with_(hmix_tracer="del2", tadvect="centered")),
                   ("tracer_centered_del4_fold",
                    cfg.with_(tadvect="centered"))):
        args = (c, opened, f["ucur"], f["vcur"], f["trcr"], f["tmix"],
                f["told"], f["vdc"], f["stf"], f["dh"])
        got = tracer_cuda.tracer_tendency(*args)
        torch.cuda.synchronize()
        want = tracer_cuda.tracer_tendency_plain(*args)
        err_abs, err_rel = compare("tracer", dt, [got], [want])
        share = pbc_share("tracer", dt, [got], [tracer_cuda.tracer_tendency(
            c, full_cells(opened), *args[2:])])
        del got, want
        if key != "tracer_upwind3_pbc":
            worst[key], worst[key + "_pbc_share"] = err_rel, share
            continue
        # the upwind3 tile's bytes (fold_kernel_phase's tracer_upwind3) and
        # KMU, DZBT, DZBU
        rec[key] = timed(
            lambda: tracer_cuda.tracer_tendency(*args),
            lambda: tracer_cuda.tracer_tendency_plain(*args),
            s * (N * (4 + 2 * nt) + P * (nt + 8 + 12 + 2) + 10 * km)
            + 8 * P, N * (40 + 120 * nt), max_abs_err=err_abs,
            rel_err=err_rel, pbc_share=share,
            **launch_info("tracer", dt, ng=min(nt, tracer_cuda.MAX_GROUP),
                          del2=False, upwind3=True, fold=True, pbc=True))

    rhoavg = pgrad.rho_average(cfg, grid, *f["rho"], True)
    wc, wo = clinic_cuda.coriolis_weights(cfg, True)
    wet = float(grid.kmask_u.to(torch.float64).mean())
    for key, c in (("clinic_pbc", cfg),
                   ("clinic_del2_fold", cfg.with_(hmix_momentum="del2"))):
        args = (c, grid, f["ucur"], f["vcur"], f["uold"], f["vold"],
                f["uold"], f["vold"], rhoavg, f["vvc"], f["smf"], f["dhu"],
                wc, wo)
        got = clinic_cuda.clinic_rhs_fields(*args)
        torch.cuda.synchronize()
        want = clinic_cuda.clinic_rhs_plain(*args)
        err_abs, err_rel = compare("clinic", dt, got, want)
        share = pbc_share("clinic", dt, got, clinic_cuda.clinic_rhs_fields(
            c, full_cells(grid), *args[2:]))
        del got, want
        if key != "clinic_pbc":
            worst[key], worst[key + "_pbc_share"] = err_rel, share
            continue
        # clinic_aniso's bytes and DZBU
        rec[key] = timed(
            lambda: clinic_cuda.clinic_rhs_fields(*args),
            lambda: clinic_cuda.clinic_rhs_plain(*args),
            s * (N * (6 * wet + 2) + P * (10 + 2 + 1 + 2 + 1) + 5 * km)
            + 4 * P, N * wet * 150, max_abs_err=err_abs, rel_err=err_rel,
            pbc_share=share, ocean_fraction_u=wet,
            **launch_info("clinic", dt, hdiffu=False, pbc=True))
    emit({"phase": "pbc_modes", "dtype": dtype_name,
          "rel_err_of_scale": worst,
          "band": {k: BAND[(k, dt)] for k in ("thomas", "tracer",
                                              "clinic")}})
    return rec


def menu_parts_phase(dtype_name: str, n_timed: int = 10):
    """The plain parts that prod_vmix and prod_hmix add, each timed alone at
    full size on the production grid: Polzin's profile of a step's N^2,
    the NIW energy from the boundary-layer energy with its mixing, the
    whole KPP pipeline under prod_vmix's menu beside prod_mix's, and the
    biharmonic tracer (nt = 2) and momentum mixing. Inputs: the stratified
    tracers of ``sample.grid_tracers`` under ``kpp_state``'s forcing. The
    TSU subtraction is ``kernel_phase``'s (``clinic_topostress``)."""
    cfg = full_config(dtype_name, "prod_vmix")
    grid = build_grid(cfg, DEV)
    bc = grid_bc(cfg)
    km = cfg.km
    tmix = sample.grid_tracers(cfg, grid, SEED + 31)
    kout, kpp_run = kpp_state(cfg, grid, tmix, SEED + 32)
    mix = kpp_state(full_config(dtype_name, "prod_mix"), grid, tmix[:2],
                    SEED + 32)[1]
    st = kpp.build_statics(cfg, grid)
    dbloc = kpp.buoydiff(cfg, grid, st, tmix)[0]
    n2 = dbloc / grid.vgrid.dzw[1:km + 1].reshape(km, 1, 1)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 33)
    mu = grid.kmask_u.to(cfg.torch_dtype)

    def vel():
        return 5.0 * torch.randn(km, cfg.ny, cfg.nx, generator=gen,
                                 device=DEV, dtype=cfg.torch_dtype) * mu
    umix, vmix_, ucur, vcur = vel(), vel(), vel(), vel()
    visc, vdc = kpp.ri_iwmix(cfg, grid, bc, st, dbloc, umix, vmix_)[:2]

    def niw():
        en = kpp.niw_energy(cfg, grid, st, kout.kbl, umix, vmix_, ucur, vcur)
        return kpp.niw_mix(cfg, grid, st, dbloc, kout.hblt, kout.kbl, visc,
                           vdc, vdc, en=en)
    hcfg = full_config(dtype_name, "prod_hmix")
    parts = {
        "polzin_profile": lambda: tidal_mixing.polzin_diff(
            cfg, grid, st.tidal_polzin, n2),
        "niw_blke_energy_and_mix": niw,
        "kpp_prod_vmix_menu": kpp_run,
        "kpp_prod_mix_menu": mix,
        "del4_tracer_nt2": lambda: hmix.hdifft_del4(hcfg, grid, bc,
                                                    tmix[:2]),
        "del4_momentum": lambda: hmix.hdiffu_del4(hcfg, grid, bc, umix,
                                                  vmix_),
    }
    for name, fn in parts.items():
        out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        if not all(bool(torch.isfinite(o).all()) for o in outs
                   if isinstance(o, torch.Tensor)):
            raise AssertionError(f"{name} {dtype_name}: not finite")
    ms = {name: time_ms(fn, 2, n_timed) for name, fn in parts.items()}
    emit({"phase": "menu_parts", "dtype": dtype_name,
          "dims": [cfg.nx, cfg.ny, km], "plain_ms": ms})
    return ms


def search_bytes(grid, dd, sla, rb, tlt, value_bytes: int) -> int:
    """Bytes the transition-layer search kernel moves for this run's
    inputs: every column reads its diabatic depth, Rossby radius and bottom
    level and writes four 2-D fields; the slope measures count as the
    values gm_tlt.cu loads, found by following its three passes for all
    columns at once (a value read twice counts once). The K_LEVEL this walk
    reaches must be the kernel's, or the count follows another search."""
    km = sla.shape[1]
    zt, zw = grid.vgrid.zt, grid.vgrid.zw
    kmt = grid.KMT.long()
    seen = torch.zeros(sla.shape, dtype=torch.bool, device=sla.device)

    def load(half, q, on):
        """sla[half, q] per column (q a (ny, nx) level index), marked read
        where ``on``."""
        q = q.clamp(0, km - 1)[None]
        seen[half].scatter_(0, q, seen[half].gather(0, q) | on[None])
        return sla[half].gather(0, q)[0]

    # pass 1: no slope measure
    k1 = (dd[None] >= zw.reshape(-1, 1, 1)).sum(dim=0)   # 0-based
    fired = (k1 < km) & (kmt != 0)
    at_zt = fired & (k1 != 0) & (dd < zt[k1.clamp(max=km - 1)])
    k_level = torch.where(fired, k1 + 1, 0)
    k_start = torch.where(fired, torch.where(at_zt, k1 + 1, k1 + 2), 0)
    compute = ~((kmt == 0) | (k_start > kmt) | ((k_start == kmt) & at_zt))
    # pass 2: the bottom half of K_START's level and the top of the next
    on = compute & at_zt & (k_start < kmt) & (k_start <= km - 1)
    q = k_start - 1
    work = torch.maximum(load(1, q, on), load(0, q + 1, on)) * rb
    hit = on & (work != 0)
    reach = dd >= zw[q.clamp(0, km - 1)] - work
    compute = compute & ~(hit & ~reach)
    k_level = torch.where(hit & reach, k_start, k_level)
    k_start = k_start + (hit & reach).long()
    # pass 3: level k's two halves, then its bottom interface, which also
    # reads the top half of k + 1 above the column's bottom
    active = compute & (k_start >= 2)
    for k in range(2, km + 1):
        q = k - 1
        on = active & (k >= k_start) & (k <= kmt)
        seen[:, q] |= on[None]
        work = torch.maximum(sla[0, q], sla[1, q]) * rb
        hit = on & (work != 0)
        stop = hit & ~(dd >= zt[q] - work)
        k_level = torch.where(hit & ~stop, k, k_level)
        on, active = on & ~stop, active & ~stop
        work = sla[1, q] * rb
        if k < km:
            below = on & (k < kmt)
            seen[0, k] |= below
            work = torch.where(below, torch.maximum(sla[1, q], sla[0, k])
                               * rb, work)
        hit = on & (work != 0)
        stop = hit & ~(dd >= zw[q] - work)
        k_level = torch.where(hit & ~stop, k, k_level)
        active = active & ~stop
    if not torch.equal(k_level.to(tlt.k_level.dtype), tlt.k_level):
        raise AssertionError("search_bytes: the walk's K_LEVEL is not the "
                             "kernel's")
    ncol = dd.numel()
    return int(value_bytes * (int(seen.sum()) + 4 * ncol + 2 * km)
               + 4 * 3 * ncol)


def mix_kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """The kernels of the prod_mix path beyond prod_dyn's, each against its
    plain version at the path's shapes on the fold bottom, with times and
    bounds: the transition-layer search from the smoothed boundary layer
    that KPP (plain) gives a stratified state under a cooling surface flux,
    and the chain kernel with the submesoscale fold-in under KPP's
    mixed-layer depth, for prod_mix's two tracers and prod_full's five,
    with the top row's north faces opened (``sample.open_top_face``) and
    the fold's share of the top row held far above the band. Also times the
    plain search on the same inputs and KPP itself. Returns {name:
    record}."""
    cfg = full_config(dtype_name, "prod_mix")
    dt = cfg.torch_dtype
    grid, bc, tr = fold_case(cfg)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    tmix = sample.grid_tracers(cfg, grid, SEED + 16)
    kout, kpp_run = kpp_state(cfg, grid, tmix, SEED + 17)
    kpp_ms = time_ms(kpp_run, 1, 3)
    del kpp_run
    rec = {}

    def timed(fn, plain, nbytes, flops, **info):
        r = {"ms": time_ms(fn, 3, n_timed),
             "ms_back_to_back": time_ms_back_to_back(fn, n_timed),
             "plain_ms": time_ms(plain, 1, 3)}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dt)
        r.update(info)
        return r

    # ---- the search, from the smoothed boundary layer
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, tr, tmix)
    rb = gm._rossby_radius(grid)
    dd = gm.diabatic_depth(cfg, grid, bc, kout.hblt)
    args = (cfg, grid, dd, sla, rb)
    got = gm_tlt_cuda.transition_layer(*args)
    torch.cuda.synchronize()
    want = gm.transition_layer(*args)
    err_abs, err_rel, bitwise = compare_search("gm_tlt", dt, got, want)
    nbytes = search_bytes(grid, dd, sla, rb, got, s)
    ocean = grid.KMT > 0
    rec["gm_tlt_search"] = timed(
        lambda: gm_tlt_cuda.transition_layer(*args),
        lambda: gm.transition_layer(*args), nbytes, nbytes / s * 4,
        max_abs_err=err_abs, rel_err=err_rel, bitwise=bitwise,
        deepest_level=int(got.k_level.max()),
        mean_level=float(got.k_level[ocean].to(torch.float64).mean()),
        hblt_deepest_level=int(kout.kbl.max()), bytes=nbytes,
        **launch_info("gm_tlt", dt))
    emit({"phase": "kpp_plain", "dtype": dtype_name, "ms": kpp_ms,
          "hblt_m": [float(kout.hblt[ocean].min()) / 100.0,
                     float(kout.hblt[ocean].mean()) / 100.0,
                     float(kout.hblt[ocean].max()) / 100.0],
          "kbl_levels": [int(kout.kbl[ocean].min()),
                         int(kout.kbl[ocean].max())]})

    # ---- chain with the submesoscale fold-in, on the fold with the top
    # row's north faces opened: the prod_mix path's instance (bfre, no
    # diagnostics; nt = 2) and the prod_full path's (nt = 5, the passive
    # tracers beside the same T and S); the five amplitude planes join the
    # inputs
    tlt = got
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    sm = submeso.amplitudes(cfg, grid, bc, tr, tmix, kout.hmxl)
    opened = sample.open_top_face(grid)
    cfg5 = full_config(dtype_name, "prod_full")
    tm5 = torch.cat([tmix, sample.grid_tracers(cfg5, grid, SEED + 22)[2:]])
    for key, c, tm in (("gm_chain_sm", cfg, tmix),
                       ("gm_chain_sm_nt5", cfg5, tm5)):
        n = c.nt
        args = (c, opened, bc, tm, slp, sla, kv, tlt, False, sm)
        got = gm_chain_cuda.chain(*args)[:2]
        torch.cuda.synchronize()
        want = gm_chain_cuda.chain_plain(*args)[:2]
        err_abs, err_rel, excused = compare_chain("gm_chain", dt, got, want)
        top = compare_chain("gm_chain", dt, [g[..., -2:, :] for g in got],
                            [w[..., -2:, :] for w in want])[1]
        fold_share = chain_fold_share(key, dt, c, args, want[0])
        # the fold-in moved the tendency: without it the kernel's GTK
        # differs, by how much, and whether the band above refuses a
        # dropped fold-in (float64 must: its relative band is 0)
        plain_gm = gm_chain_cuda.chain(*args[:-1])[0]
        sm_share = float((got[0] - plain_gm).abs().max()
                         / got[0].abs().max())
        dropped_refused = not chain_band("gm_chain", dt, plain_gm,
                                         want[0])[3]
        if dt == torch.float64 and not dropped_refused:
            raise AssertionError(f"{key} float64: the chain without the "
                                 "fold-in passes the band of the one with "
                                 "it")
        del got, want, plain_gm
        rec[key] = timed(
            lambda: gm_chain_cuda.chain(*args),
            lambda: gm_chain_cuda.chain_plain(*args),
            s * (N * (2 * n + 12) + 11 * P + 8 * km) + 12 * P,
            N * (420 + 80 * n), max_abs_err=err_abs, rel_err=err_rel,
            rel_err_top_rows=top, points_within_relative_band_only=excused,
            fold_share_of_top_row=fold_share, submeso_share_of_gtk=sm_share,
            dropped_fold_in_refused=dropped_refused,
            **launch_info("gm_chain", dt, nt=n, sm=True,
                          flags=gm_chain_cuda.kernel_flags(c, False, True)))

    # ---- prod_full's instance with the diagnostic columns (KAPPA_ISOP,
    # KAPPA_THIC, HOR_DIFF), the path under a tavg stream (tavg_phase):
    # three (km, ny, nx) outputs more
    n = cfg5.nt
    args = (cfg5, opened, bc, tm5, slp, sla, kv, tlt, True, sm)
    got = gm_chain_cuda.chain(*args)
    torch.cuda.synchronize()
    want = gm_chain_cuda.chain_plain(*args)
    err_abs, err_rel, excused = compare_chain(
        "gm_chain", dt, (got[0], got[1], *got[2]),
        (want[0], want[1], *want[2]))
    diag_rel = compare_chain("gm_chain", dt, list(got[2]),
                             list(want[2]))[1]
    del got, want
    plan = gm_chain_cuda.launch_plan(s, n, True)
    rec["gm_chain_sm_nt5_diags"] = timed(
        lambda: gm_chain_cuda.chain(*args),
        lambda: gm_chain_cuda.chain_plain(*args),
        s * (N * (2 * n + 15) + 16 * P + 8 * km) + 12 * P,
        N * (430 + 80 * n), max_abs_err=err_abs, rel_err=err_rel,
        rel_err_diag_columns=diag_rel,
        points_within_relative_band_only=excused,
        launch_plan=[list(plan[0]), plan[1]],
        **launch_info("gm_chain", dt, nt=n, sm=True,
                      flags=gm_chain_cuda.kernel_flags(cfg5, True, True)))
    return rec


def flux_fold_phase(dtype_name: str, n_timed: int = N_TIMED):
    """The flux-assembly kernel's tripole row, the prod_flux path's GM, on
    the fold bottom with the top row's north faces opened
    (``sample.open_top_face``), at the path's shapes: nt = 5 in both
    branches against the plain version, timed (the path's instance is the
    cancellation branch), and nt = 2 in both; the same of the anisotropic
    instances (prod_aniso's GM: the cancellation branch; the y faces'
    diffusivity ``aniso_kisop_y``), record ``gm_flux_aniso``. The fold must
    matter: the top row of the plain version with a closed north edge has
    to differ from the tripole one by far more than the band. Returns
    {name: record}."""
    cfg = full_config(dtype_name, "prod_flux")
    dt = cfg.torch_dtype
    grid, bc, tr = fold_case(cfg)
    grid = sample.open_top_face(grid)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    tmix = sample.grid_tracers(cfg, grid, SEED + 20)
    f = sample.flux_operands(cfg, grid, bc, tr, tmix)
    del tmix
    closed_bc = grid_bc(cfg.with_(ns_boundary="closed"))
    ky = aniso_kisop_y(f[7])
    recs = {}
    for aniso, n, cancellation in itertools.product(
            (False, True), (nt, 2), (True, False)):
        r = recs.setdefault("gm_flux_aniso" if aniso else "gm_flux_tripole",
                            {})
        kw = {"kisop_y": ky} if aniso else {}
        ops = [t[:n].contiguous() for t in f[:3]] + list(f[3:])
        c = cfg if n == nt else cfg.with_(passive_tracers=(), nt=2)
        args = (c, grid, bc, *ops, cancellation)
        got = gm_cuda.flux_assembly(*args, **kw)
        torch.cuda.synchronize()
        want = gm_cuda.flux_assembly_plain(*args, **kw)
        err_abs, err_rel = compare("gm_flux", dt, got[:1], want[:1])
        vdc_rel = compare_vdc("gm_flux", dt, got[1], want[1])
        top = compare("gm_flux", dt, [got[0][..., -1, :]],
                      [want[0][..., -1, :]])[1]
        closed = gm_cuda.flux_assembly_plain(
            c.with_(ns_boundary="closed"), grid, closed_bc, *ops,
            cancellation, **kw)[0]
        fold_share = float((closed[..., -1, :] - want[0][..., -1, :]).abs()
                           .max() / want[0][..., -1, :].abs().max())
        if not fold_share > 100.0 * BAND[("gm_flux", dt)]:
            raise AssertionError(f"gm_flux_tripole {dtype_name} (aniso "
                                 f"{aniso}): the fold moves the top row by "
                                 f"{fold_share:.2e} only; the check cannot "
                                 "see it")
        del got, want, closed
        tag = ("" if n == nt else f"_nt{n}") + ("" if cancellation
                                                 else "_skew")
        r.update({"max_abs_err" + tag: err_abs, "rel_err" + tag: err_rel,
                  "vdc_rel_err" + tag: vdc_rel, "rel_err_top_row" + tag: top,
                  "fold_share_of_top_row" + tag: fold_share})
        if n != nt:
            continue
        # the anisotropic instances read the y faces' diffusivity besides:
        # two fields more
        n_in = ((2 * n + 12 if cancellation else 3 * n + 20)
                + (2 if aniso else 0))
        b_ms, b_by = bound(s * (N * (n_in + n + 1) + 3 * P + 3 * km) + 4 * P,
                           N * (60 + 60 * n), dt)
        r.update({
            "ms" + tag: time_ms(lambda: gm_cuda.flux_assembly(*args, **kw),
                                3, n_timed),
            "ms_back_to_back" + tag: time_ms_back_to_back(
                lambda: gm_cuda.flux_assembly(*args, **kw), n_timed),
            "plain_ms" + tag: time_ms(
                lambda: gm_cuda.flux_assembly_plain(*args, **kw), 1, 3),
            "bound_ms" + tag: b_ms, "bound_by" + tag: b_by,
            **launch_info("gm_flux", dt, tag, nt=n,
                          cancellation=cancellation, fold=True,
                          aniso=aniso)})
    return recs


def _group_bitwise(name, got, part, n0, n, first):
    """Raise unless a group's own call ``part`` equals rows n0..n0+n of the
    grouped call ``got`` bitwise (gtk; VDC_GM and what else it returns for
    the first group)."""
    if not torch.equal(part[0], got[0][n0:n0 + n]):
        raise AssertionError(f"{name}: tracers {n0}..{n0 + n - 1} differ "
                             "between the grouped call and their group's "
                             "own call")
    if first and not all(torch.equal(a, b) for a, b in zip(
            part[1:], got[1:]) if a is not None):
        raise AssertionError(f"{name}: VDC_GM (or the diagnostic columns) of "
                             "the grouped call differ from the first "
                             "group's own call")


def bgc_kernel_phase(dtype_name: str, n_timed: int = N_TIMED):
    """prod_bgc's 39 tracers through the GM chain kernel (its launches,
    ``gm_chain_cuda.tracer_groups``: 8 + 8 + 8 + 8 + 7 in float32, 13 + 13
    + 13 in float64) and the flux assembly (its tripole row, both branches,
    13 + 13 + 13, ``gm_cuda.tracer_groups``), on the fold bottom with the top row's north faces
    opened, under KPP's layers of a stratified state: against the plain
    versions (a group at a time, ``chain_plain_grouped``), and bitwise
    checks of the split: each
    group of a 39-tracer call equals that group's own call, VDC_GM the
    first group's, and the first five tracers of a call with the
    diagnostic columns equal a call on those five. Times, bounds, launch
    plans of a group. Returns {name: record}."""
    cfg = full_config(dtype_name, "prod_bgc")
    dt = cfg.torch_dtype
    grid, bc, tr = fold_case(cfg)
    km, ny, nx, nt = cfg.km, cfg.ny, cfg.nx, cfg.nt
    N, P, s = km * ny * nx, ny * nx, torch.finfo(dt).bits // 8
    groups = gm_chain_cuda.tracer_groups(nt, s, True)
    tmix = sample.grid_tracers(cfg, grid, SEED + 51)
    kout = kpp_state(cfg, grid, tmix[:2].contiguous(), SEED + 52)[0]
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, tr, tmix)
    tlt = gm_tlt_cuda.transition_layer(
        cfg, grid, gm.diabatic_depth(cfg, grid, bc, kout.hblt), sla,
        gm._rossby_radius(grid))
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    sm = submeso.amplitudes(cfg, grid, bc, tr, tmix, kout.hmxl)
    grid = sample.open_top_face(grid)
    del kout, n2
    rec = {}

    def timed(fn, plain, nbytes, flops, **info):
        r = {"ms": time_ms(fn, 3, n_timed),
             "ms_back_to_back": time_ms_back_to_back(fn, n_timed),
             "plain_ms": time_ms(plain, 1, 3)}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dt)
        r.update(info)
        return r

    # ---- the chain: prod_bgc's instance (bfre, the submesoscale fold-in,
    # no diagnostic columns)
    def chain(t, diags=False):
        return gm_chain_cuda.chain(cfg, grid, bc, t, slp, sla, kv, tlt,
                                   diags, sm)

    def chain_plain():
        return chain_plain_grouped(cfg, grid, bc, tmix, slp, sla, kv, tlt,
                                   False, sm)[:2]
    before = gm_chain_cuda.launches
    got = chain(tmix)[:2]
    if gm_chain_cuda.launches - before != len(groups):
        raise AssertionError(f"gm_chain nt={nt}: "
                             f"{gm_chain_cuda.launches - before} launches, "
                             f"groups {groups}")
    torch.cuda.synchronize()
    err_abs, err_rel, excused = compare_chain("gm_chain", dt, got,
                                              chain_plain())
    for g, (n0, n) in enumerate(groups):
        _group_bitwise("gm_chain", got, chain(tmix[n0:n0 + n]), n0, n,
                       g == 0)
    five = chain(tmix[:5], True)
    _group_bitwise("gm_chain diags", chain(tmix, True), five, 0, 5, True)
    del got, five
    g0 = groups[0][1]
    rec["gm_chain_sm_nt39"] = timed(
        lambda: chain(tmix), chain_plain,
        s * (N * (2 * nt + 12) + 11 * P + 8 * km) + 12 * P,
        N * (420 + 80 * nt), max_abs_err=err_abs, rel_err=err_rel,
        points_within_relative_band_only=excused, groups=groups,
        launches_a_call=len(groups), group_bitwise=True,
        **launch_info("gm_chain", dt, nt=g0, sm=True,
                      flags=gm_chain_cuda.kernel_flags(cfg, False, True)))
    del slp, sla, kv, tlt, sm

    # ---- the flux assembly's tripole row at 39 tracers, both branches
    groups = gm_cuda.tracer_groups(nt)
    f = sample.flux_operands(cfg, grid, bc, tr, tmix)
    del tmix
    r = {}
    for cancellation in (True, False):
        def flux(lo=0, hi=nt):
            return gm_cuda.flux_assembly(
                cfg, grid, bc, *(t[lo:hi] for t in f[:3]), *f[3:],
                cancellation)

        def flux_plain():
            return flux_plain_grouped(cfg, grid, bc, *f,
                                      cancellation=cancellation)
        got = flux()
        torch.cuda.synchronize()
        want = flux_plain()
        err_abs, err_rel = compare("gm_flux", dt, got[:1], want[:1])
        vdc_rel = compare_vdc("gm_flux", dt, got[1], want[1])
        for g, (n0, n) in enumerate(groups):
            _group_bitwise("gm_flux", got, flux(n0, n0 + n), n0, n, g == 0)
        _group_bitwise("gm_flux first five", got, flux(0, 5), 0, 5, True)
        del got, want
        tag = "" if cancellation else "_skew"
        r.update({"max_abs_err" + tag: err_abs, "rel_err" + tag: err_rel,
                  "vdc_rel_err" + tag: vdc_rel, "group_bitwise" + tag: True})
        if not cancellation:
            continue
        b_ms, b_by = bound(s * (N * (3 * nt + 12) + 3 * P + 3 * km) + 4 * P,
                           N * (60 + 60 * nt), dt)
        r.update({"ms": time_ms(flux, 3, n_timed),
                  "ms_back_to_back": time_ms_back_to_back(flux, n_timed),
                  "plain_ms": time_ms(flux_plain, 1, 3), "bound_ms": b_ms,
                  "bound_by": b_by, "groups": groups,
                  "launches_a_call": len(groups),
                  **launch_info("gm_flux", dt, nt=groups[0][1],
                                cancellation=True,
                                fold=True)})
    rec["gm_flux_tripole_nt39"] = r
    return rec


def bgc_inputs(cfg, seed: int):
    """prod_bgc's tracers (old, cur) from the packages' initial fields, each
    ecosystem field varied point by point by a seeded 30 % (a few below
    zero, which the interior sources clip; O2 low at a fifth of the
    points), T by 0.3 K, the old level's passive tracers by 1 %, and a
    forcing with shortwave, a 5-10 m/s wind and sea ice over part of the
    surface: NumPy float64, made on the host from the config alone, the
    same for any device and either dtype; with the packages."""
    from pop2_tpu_torch.passive_tracers import PassiveTracers
    return (*_bgc_arrays(cfg.with_(dtype="float64"), seed),
            PassiveTracers(cfg, cfg.passive_tracers))


@functools.lru_cache(maxsize=1)
def _bgc_arrays(c64, seed: int):
    """``bgc_inputs``' arrays, made once a float64 config and seed (at full
    size they take seconds on the host)."""
    from pop2_tpu_torch.passive_tracers import PassiveTracers
    grid = build_grid(c64, "cpu")
    passive = PassiveTracers(c64, c64.passive_tracers)
    cur = initial_state(c64, grid, "cpu",
                        passive=passive).tracer_cur.numpy().copy()
    rng = np.random.default_rng(seed)
    mt = grid.kmask_t.numpy()
    cur[0] += 0.3 * rng.standard_normal(mt.shape)
    eco = cur[BGC_SLOT0:BGC_SLOT0 + len(ecosys.TRACER_NAMES)]
    eco *= 1.0 + 0.3 * rng.standard_normal(eco.shape)
    eco[ecosys.IDX["O2"]] *= np.where(rng.random(mt.shape) < 0.2, 0.01, 1.0)
    old = cur.copy()
    old[2:] *= 1.0 + 0.01 * rng.standard_normal(old[2:].shape)
    shape = mt.shape[1:]
    forcing = dict(
        shf_qsw=4.0e-3 * np.abs(rng.standard_normal(shape)) * mt[0],
        u10_sqr=U10_SQR * (0.5 + rng.random(shape)),
        ifrac=np.clip(1.5 * rng.random(shape) - 0.5, 0.0, 1.0))
    return old * mt, cur * mt, forcing


def bgc_phase(n_timed: int = 5):
    """The ocean biogeochemistry on the card against the CPU in float64 at
    prod_bgc's width (320 x 384) on 20 internal levels: the carbonate solve
    (``co2calc_surface``) of the ecosystem's surface DIC and alkalinity,
    the ecosystem's interior sources and surface fluxes, the abiotic DIC's;
    each output within FORCING_BAND of its scale. Then each part's device
    time at full size (60 levels) in float32 and float64, with the three
    carbonate solves of a step (the ecosystem's DIC and DIC_ALT_CO2, the
    abiotic DIC) timed alone: the ecosystem's plain cost a step. Returns
    {dtype: {part: ms}}."""
    def parts(cfg, grid, seed):
        old, cur, frc, passive = bgc_inputs(cfg, seed)
        dev, dt = grid.KMT.device, cfg.torch_dtype

        def t(a):
            return torch.as_tensor(a, device=dev, dtype=dt)
        to, tc = t(old), t(cur)
        f = forcing_mod.analytic_forcing(cfg, grid).replace(
            **{k: t(v) for k, v in frc.items()})
        eco, abio = passive.packages[2], passive.packages[3]
        sst = torch.clamp(tc[0, 0], -2.0, 35.0)
        sss = torch.clamp(tc[1, 0] * const.SALT_TO_PPT, 4.0, 40.0)
        dic, alk = (torch.clamp(tc[BGC_SLOT0 + ecosys.IDX[n], 0], 100.0,
                                4000.0)
                    * 1.0e-6 / 1.026 for n in ("DIC", "ALK"))
        return {
            "ecosys_set_interior": lambda: eco.set_interior(cfg, grid, to,
                                                            tc, f),
            "ecosys_set_sflux": lambda: eco.set_sflux(cfg, grid, to, tc, f),
            "abio_dic_set_sflux": lambda: abio.set_sflux(cfg, grid, to, tc,
                                                         f),
            "abio_dic_set_interior": lambda: abio.set_interior(cfg, grid, to,
                                                               tc, f),
            "co2calc_surface": lambda: co2calc.co2calc_surface(sst, sss, dic,
                                                               alk)}

    cfg = full_config("float64", "prod_bgc").with_(km=20)
    res = {}
    for dev in ("cpu", DEV):
        res[str(dev)] = {n: fn() for n, fn in parts(
            cfg, build_grid(cfg, dev), SEED + 61).items()}
    torch.cuda.synchronize()
    errs = {}
    for name, got in res[str(DEV)].items():
        want = res["cpu"][name]
        pairs = (zip(got, want) if isinstance(got, tuple)
                 else zip(got.unbind(0), want.unbind(0)))
        errs[name] = max(_scale_err(g, w) for g, w in pairs)
    ph = res[str(DEV)]["co2calc_surface"].ph
    emit({"phase": "bgc", "dims": [cfg.nx, cfg.ny, cfg.km],
          "band": FORCING_BAND, "rel_err": errs,
          "ph_range": [float(ph.min()), float(ph.max())]})
    broken = {k: v for k, v in errs.items() if not v <= FORCING_BAND}
    if broken:
        raise AssertionError(f"bgc: GPU and CPU differ beyond "
                             f"{FORCING_BAND}: {broken}")
    del res
    ms, device_ms = {}, {}
    for dtype_name in ("float32", "float64"):
        full = full_config(dtype_name, "prod_bgc")
        fns = parts(full, build_grid(full, DEV), SEED + 62)
        ms[dtype_name] = {n: time_ms(fn, 2, n_timed)
                          for n, fn in fns.items()}
        device_ms[dtype_name] = {n: captured_ms(fn, n_timed)
                                 for n, fn in fns.items()}
        del fns
    _bgc_arrays.cache_clear()
    emit({"phase": "bgc_parts", "dims": [cfg.nx, cfg.ny, 60],
          "plain_ms": ms, "captured_device_ms": device_ms,
          "note": "a step runs the carbonate solve three times"})
    return device_ms


def captured_ms(fn, n_timed: int) -> float:
    """The device time of ``fn`` alone, as a captured step runs it: ``fn``
    captured in a CUDA graph (after a warm-up call) and its replays timed
    by CUDA events (median); without the host's launch time, which a plain
    part's eager call of thousands of small kernels is made of."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, 2, n_timed)
    del graph
    return ms


# The overflows of the JAX package's overflow tests (tests/test_overflows.py)
# on the 'mini' preset: a box-only one, and one with sidewall points and two
# product sets
OVF_BOX = OverflowSpec(
    name="test_ovf", lat=60.0, width=1.0e7, source_thick=3.0e4,
    distnc_str_ssb=1.0e7, bottom_slope=0.01, bottom_drag=3.0e-3,
    inf=RegionBox(kmin=1, kmax=2, jmin=16, jmax=18, imin=2, imax=5),
    src=RegionBox(kmin=2, kmax=3, jmin=16, jmax=18, imin=6, imax=9),
    ent=RegionBox(kmin=3, kmax=4, jmin=14, jmax=16, imin=10, imax=13),
    prd=RegionBox(kmin=5, kmax=6, jmin=12, jmax=14, imin=10, imax=13))
OVF_POINTS = OverflowSpec(
    name="pt_ovf", lat=60.0, width=1.0e7, source_thick=3.0e4,
    distnc_str_ssb=1.0e7, bottom_slope=0.01, bottom_drag=3.0e-3,
    inf=RegionBox(kmin=1, kmax=2, jmin=16, jmax=18, imin=2, imax=5),
    src=RegionBox(kmin=2, kmax=3, jmin=16, jmax=18, imin=6, imax=8),
    ent=RegionBox(kmin=3, kmax=4, jmin=14, jmax=16, imin=14, imax=16),
    prd=RegionBox(kmin=5, kmax=6, jmin=12, jmax=14, imin=14, imax=16),
    src_pts=tuple((5, j, 3, 1) for j in range(16, 19)),
    ent_pts=tuple((13, j, 3, 1) for j in range(14, 17)),
    prd_sets=(tuple((13, j, 5, 1) for j in range(12, 15)),
              tuple((13, j, 6, 1) for j in range(12, 15))))
# kmt records that disagree with the internal topography: the model warns
# and deactivates the overflow that carries them
OVF_MISMATCHED = OverflowSpec(**{**vars(OVF_POINTS), "name": "mismatched",
                                 "kmt_changes": ((6, 16, 3, 2),)})


def overflow_phase(nsteps: int = 5):
    """The overflows on the card against the same on the CPU: the 'mini'
    preset with the box-only and the point-data overflow (and beside the
    latter one whose kmt records disagree with the topography), nsteps
    steps from a state with the source region 4 K colder. float64 within
    1e-11 of scale; float32 (its 2-D solve in float64) within WITNESS_RATIO
    times the CPU float32 run's own distance from the float64 run.
    ``validate_geometry``'s warning and the overflows it keeps are the same
    on both devices. Prints the first step's transports."""
    import warnings
    out = {}
    for kind, specs in (("box", (OVF_BOX,)),
                        ("points", (OVF_POINTS, OVF_MISMATCHED))):
        runs, warned, first = {}, {}, {}
        for dtype_name, (where, device) in itertools.product(
                ("float64", "float32"),
                (("gpu", DEV), ("cpu", torch.device("cpu")))):
            cfg = get_config("mini", dtype=dtype_name, overflows=specs,
                             solver=SolverConfig(solve_dtype="float64"))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                model = Model(cfg, device=device)
            key = (dtype_name, where)
            warned[key] = ([str(w.message) for w in caught],
                           [o.name for o in model.cfg.overflows])
            src = torch.as_tensor(overflows.region_mask3(
                model.cfg, model.ovf_statics, 0, overflows.REG_SRC) > 0,
                device=device)
            state = model.initial_state()
            tracer = state.tracer_cur.clone()
            tracer[0] = torch.where(src, tracer[0] - 4.0, tracer[0])
            state = state.replace(tracer_cur=tracer, tracer_old=tracer)
            ms, me, mp, phi, _ = overflows.transports(
                model.cfg, model.grid, model.ovf_statics, tracer)
            first[key] = {"ms": ms.tolist(), "me": me.tolist(),
                          "mp": mp.tolist(), "phi": phi.tolist()}
            reset_counts()
            for _ in range(nsteps):
                state, _ = model.advance(state)
            if where == "cpu" and any(read_counts().values()):
                raise AssertionError("the CPU run launched a kernel")
            runs[key] = state
        if len({repr(v) for v in warned.values()}) != 1:
            raise AssertionError(f"overflows {kind}: validate_geometry "
                                 f"differs between devices: {warned}")
        if first[("float64", "gpu")]["ms"][0] <= 0.0:
            raise AssertionError(f"overflows {kind}: no transport")
        d64 = _state_diffs(runs[("float64", "gpu")],
                           runs[("float64", "cpu")])
        d32 = _state_diffs(runs[("float32", "gpu")],
                           runs[("float32", "cpu")])
        w32 = _state_diffs(runs[("float32", "cpu")],
                           runs[("float64", "cpu")])
        band32 = {k: WITNESS_RATIO * v for k, v in w32.items()}
        rec = {"phase": "overflows", "kind": kind, "steps": nsteps,
               "overflows_kept": warned[("float64", "gpu")][1],
               "warnings": warned[("float64", "gpu")][0],
               "transports_first_step": {f"{d}_{t}": v for (d, t), v
                                         in first.items()},
               "rel_diff_float64": d64, "band_float64": 1e-11,
               "rel_diff_float32": d32, "band_float32": band32}
        emit(rec)
        broken = [k for k, v in d64.items() if not v <= 1e-11]
        broken += [k + "_f32" for k, v in d32.items() if not v <= band32[k]]
        if broken:
            raise AssertionError(f"overflows {kind}: GPU and CPU differ "
                                 f"beyond the band in {broken}")
        out[kind] = rec
    return out


# each wrapper's launch counter, and mode counters: the chain kernel's
# launches with the diagnostic columns, the flux assembly's tripole-row
# (FOLD) and anisotropic instances, and the partial-bottom-cell (PBC)
# instances of thomas, the tracer and the momentum kernels
COUNTERS = {"thomas": (tridiag_cuda, "launches"),
            "tracer": (tracer_cuda, "launches"),
            "clinic": (clinic_cuda, "launches"),
            "gm_slope": (gm_slope_cuda, "launches"),
            "gm_chain": (gm_chain_cuda, "launches"),
            "gm_flux": (gm_cuda, "launches"),
            "gm_tlt": (gm_tlt_cuda, "launches"),
            "gm_chain_diags": (gm_chain_cuda, "launches_with_diags"),
            "gm_flux_fold": (gm_cuda, "launches_fold"),
            "gm_flux_aniso": (gm_cuda, "launches_aniso"),
            "thomas_pbc": (tridiag_cuda, "launches_pbc"),
            "tracer_pbc": (tracer_cuda, "launches_pbc"),
            "clinic_pbc": (clinic_cuda, "launches_pbc")}


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    tridiag_cuda.launches_by_nr.clear()


def read_counts(block=None):
    """Every wrapper's launches (and the two mode counters), and thomas's by
    the right-hand sides a launch took (``thomas_nr1`` ...): the modules'
    counters, or a block's of a one-process mesh (``block``, a
    ``launch_counts.Counts``)."""
    if block is not None:
        counts = {name: block.get(mod, attr)
                  for name, (mod, attr) in COUNTERS.items()}
        by_nr = block.by_nr
    else:
        counts = {name: getattr(mod, attr)
                  for name, (mod, attr) in COUNTERS.items()}
        by_nr = tridiag_cuda.launches_by_nr
    counts.update({f"thomas_nr{n}": by_nr[n]
                   for n in range(1, tridiag_cuda.MAX_RHS + 1)})
    return counts


def thomas_schedule(nt: int):
    """(Euler step, leapfrog step): {right-hand sides: launches} of thomas
    for ``nt`` tracers. Euler: T (1) and the momentum (2), then salinity
    with the passive tracers on one factorisation in the groups of
    ``rhs_groups(nt - 1)``. Leapfrog: the predictor's T and S (1, 1), the
    momentum (2), the corrector's T and S (1, 1), then the passive tracers
    in the groups of ``rhs_groups(nt - 2)``. With T and S alone 1, 1, 2
    and 1, 1, 2, 1, 1; prod_full's nt = 5: 1, 2, 4 and 1, 1, 2, 1, 1, 3;
    prod_bgc's nt = 39: 1, 2 and eight 4s and two 3s, then 1, 1, 2, 1, 1
    and seven 4s and three 3s."""
    def add(base, n):
        out = dict(base)
        for _, m in (tridiag_cuda.rhs_groups(n) if n else ()):
            out[m] = out.get(m, 0) + 1
        return out
    return add({1: 1, 2: 1}, nt - 1), add({1: 4, 2: 1}, nt - 2)


def expected_counts(path: str, nsteps: int, dtype_name: str = "float64"):
    """Launches of ``nsteps`` steps from the initial state. The implicit
    solves: ``thomas_schedule`` of the path's tracers. The tracer kernel: a
    launch for each group of at most two tracers a step; the GM chain
    kernel a launch for each of its groups (``gm_chain_cuda.tracer_groups``:
    on prod_bgc five of 8 or 7 in float32, three of 13 in float64), the flux
    assembly for each group of at most 16 (``gm_cuda.tracer_groups``). Every
    other kernel of a path: once a step, the flux assembly in its tripole-row
    instance on prod_flux, prod_eg and prod_aniso (there anisotropic); no
    path writes the chain's diagnostic columns (no stream,
    ``tavg_phase``). core_lw launches no tracer kernel: its lw_lim
    advection and the vertical diffusion beside it are plain. On the
    partial-cell paths every tracer and momentum launch is a PBC instance's,
    and so are the predictor's solves (T and S on a leapfrog step) and the
    momentum's, not the corrector's (the JAX package's corrector solves on
    the 1-D dz)."""
    chain = ("tracer", "clinic", "gm_slope", "gm_tlt", "gm_chain")
    flux = ("tracer", "clinic", "gm_flux")
    once = {"core": ("tracer", "clinic"), "gm_full": chain,
            "gm_flux": flux, "prod_dyn": chain, "prod_mix": chain,
            "prod_full": chain, "prod_flux": flux, "prod_vmix": chain,
            "prod_hmix": ("tracer", "clinic"),
            "core_topo": ("tracer", "clinic"),
            "prod_eg": flux + ("gm_tlt",), "prod_aniso": flux,
            "core_lw": ("clinic", "gm_flux"),
            "prod_pbc": ("tracer", "clinic"), "gm_pbc": chain,
            "prod_forced": chain, "prod_bgc": chain, "prod_file": chain,
            "gx3v7": flux}[path]
    expect = dict.fromkeys(read_counts(), 0)
    expect.update(dict.fromkeys(once, nsteps))
    cfg = full_config(dtype_name, path)
    nt = cfg.nt
    if "gm_chain" in once:
        expect["gm_chain"] = nsteps * len(gm_chain_cuda.tracer_groups(
            nt, torch.finfo(cfg.torch_dtype).bits // 8, cfg.lsubmeso))
    flux_launches = nsteps * len(gm_cuda.tracer_groups(nt))
    if "gm_flux" in once:
        expect["gm_flux"] = flux_launches
    if path in ("prod_flux", "prod_eg", "prod_aniso"):  # the tripole row
        expect["gm_flux_fold"] = flux_launches
    if path == "prod_aniso":
        expect["gm_flux_aniso"] = flux_launches
    if "tracer" in once:
        expect["tracer"] = nsteps * len(tracer_cuda.tracer_groups(nt))
    euler, leapfrog = thomas_schedule(nt)
    for nr in range(1, tridiag_cuda.MAX_RHS + 1):
        expect[f"thomas_nr{nr}"] = (euler.get(nr, 0)
                                    + leapfrog.get(nr, 0) * (nsteps - 1))
    expect["thomas"] = sum(euler.values()) + sum(leapfrog.values()) * (
        nsteps - 1)
    if PATHS[path].get("partial_bottom_cells"):
        expect["tracer_pbc"] = expect["tracer"]
        expect["clinic_pbc"] = expect["clinic"]
        expect["thomas_pbc"] = 1 + 3 * (nsteps - 1)
    return expect


def file_grid_figures(cfg, grid):
    """Print what the file grid holds that the internal one does not: the
    ocean fraction, DYU's least and largest row (it varies by row, not
    along one), the columns that reach km and those with fewer than 5
    levels, and the top row's U columns (land: gridgen's top T row is
    land, so prod_file does not test the tripole fold)."""
    kmt, kmu = grid.KMT.cpu().numpy(), grid.KMU.cpu().numpy()
    dyu = grid.DYU.double().cpu().numpy()
    htn = grid.HTN.double().cpu().numpy()
    ulat = grid.ULAT.double().cpu().numpy() * const.RADIAN
    wet = kmt > 0
    rows = dyu[1:-1].mean(axis=1)
    out = {"phase": "file_grid", "dims": [cfg.nx, cfg.ny, cfg.km],
           "ocean_fraction": float(wet.mean()),
           "dyu_row_min_cm": float(rows.min()),
           "dyu_row_max_cm": float(rows.max()),
           "dyu_row_min_over_max": float(rows.min() / rows.max()),
           "dyu_max_spread_along_a_row": float(
               (dyu.max(axis=1) - dyu.min(axis=1)).max()),
           "columns_at_km": int((kmt == cfg.km).sum()),
           "columns_below_5_levels": int((wet & (kmt < 5)).sum()),
           "ocean_columns": int(wet.sum()),
           # the narrowest ocean cell, near the pole, and the northernmost
           # ocean row's latitude: what stiffens the 2-D operator
           "htn_ocean_min_cm": float(htn[wet].min()),
           "htn_ocean_max_cm": float(htn[wet].max()),
           "north_ocean_lat_deg": float(ulat[wet.any(axis=1)].max()),
           "angle_max_abs": float(grid.ANGLE.abs().max()),
           "top_row_u_columns": int((kmu[-1] > 0).sum())}
    emit(out)
    if not (0.5 < out["ocean_fraction"] < 0.9 and out["columns_at_km"]
            and out["columns_below_5_levels"]
            and out["dyu_row_min_over_max"] < 0.75):
        raise AssertionError(f"the file grid lacks what it was made for: "
                             f"{out}")


def path_phase(path: str, dtype_name: str):
    """Drive Model.advance at full size from the model's own initial state
    (rest, the Levitus profile), on prod_forced under a forcing composed
    anew each step; the launch counters are zeroed just before and read
    just after."""
    nsteps = STEPS[path][dtype_name]
    cfg = full_config(dtype_name, path)
    model = _model(cfg, DEV)
    if cfg.partial_bottom_cells and model.grid.DZBT is None:
        raise AssertionError(f"{path}: no partial bottom cells on the grid")
    state = model.initial_state()
    forcing = step_forcing(path, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    iters = []
    diag_step4 = None
    t0 = time.perf_counter()
    for n in range(1, nsteps + 1):
        state, diags = model.advance(state, forcing(model, state))
        iters.append(int(diags.solver_iters))
        if n == 4:  # early spin-up, for comparison with the JAX package
            diag_step4 = model.diagnostics(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    n_avg = sum(model.step_flags(n)[1] for n in range(1, nsteps + 1))
    expect = expected_counts(path, nsteps, dtype_name)
    if counts != expect:
        raise AssertionError(f"{path}: launch counts {counts}, expected "
                             f"{expect}")
    if path == "core_lw" and counts["tracer"]:
        raise AssertionError("core_lw: the tracer kernel ran under lw_lim")
    if path == "prod_file":
        if counts != expected_counts("prod_full", nsteps, dtype_name):
            raise AssertionError("prod_file: launch counts differ from "
                                 "prod_full's")
        if dtype_name == "float32":
            file_grid_figures(cfg, model.grid)
    for name, t in state.leaves():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{path} {dtype_name}: {name} not finite")
    diag = model.diagnostics(state)
    model.check_ke(state)
    if not all(math.isfinite(v) for v in diag.values()):
        raise AssertionError(f"diagnostics not finite: {diag}")
    points = cfg.nx * cfg.ny * cfg.km
    passive = {}
    if cfg.passive_tracers:
        # the gas exchange reached the CFC tracers; the age's surface reset
        sfc = state.tracer_cur[2:, 0].abs().amax(dim=(1, 2)).tolist()
        passive = {"passive_tracers": model.passive.names,
                   "surface_max": sfc}
        if not (sfc[0] == 0.0 and min(sfc[1:]) > 0.0):
            raise AssertionError(f"{path} {dtype_name}: passive tracers' "
                                 f"surface maxima {sfc}")
    emit({"phase": "path", "path": path, "dtype": dtype_name,
          "dims": [cfg.nx, cfg.ny, cfg.km], "nt": cfg.nt, "steps": nsteps,
          "averaging_steps": n_avg, "seconds": seconds,
          "steps_per_s": nsteps / seconds,
          "grid_point_steps_per_s": points * nsteps / seconds,
          "solver_iters_per_step": iters, "launches": counts,
          "diagnostics_step4": diag_step4, "diagnostics": diag,
          "peak_device_mem_bytes": torch.cuda.max_memory_allocated(),
          **passive})
    return counts


# each model's stratified tracers and densities, by seed: made once a model
# (seconds on the host at full size) and shared by its runs, which step
# from them without writing into them
_STRATIFIED = weakref.WeakKeyDictionary()


def stratified_state(model, seed: int):
    """The model's state of rest with the stratified, horizontally varying
    T and S of ``stratified_tracers`` at a fifth of its noise in place of the
    horizontally uniform profile, under which GM has nothing to mix."""
    cfg, grid = model.cfg, model.grid
    made = _STRATIFIED.setdefault(model, {})
    if seed not in made:
        tracers = sample.grid_tracers(cfg, grid, seed, noise=0.02)
        made[seed] = (tracers, baroclinic._masked_density(
            cfg, grid, model.ts_range, tracers))
    tracers, rho = made[seed]
    return model.initial_state().replace(
        tracer_cur=tracers, tracer_old=tracers, rho_cur=rho, rho_old=rho)


# the last two models built for eager runs without a stream, by config and
# device: a path's float32 and float64 runs (``path_phase``) and its
# comparison with the plain versions (``path_vs_plain_phase``: the kernel
# run and the plain run) share them. A model's construction (the grid's
# anisotropic statics on the host, the FSPAI preconditioner, PCSI's bounds)
# is seconds at full size; ``initial_state`` resets its step count and
# calendar, and no graph is captured in them.
_MODELS = collections.OrderedDict()


def _model(cfg, device):
    key = (cfg, str(device))
    if key not in _MODELS:
        if len(_MODELS) >= 2:
            _MODELS.popitem(last=False)
        _MODELS[key] = Model(cfg, device=device)
    _MODELS.move_to_end(key)
    return _MODELS[key]


def _run_steps(cfg, nsteps, device=DEV, stratified: bool = False,
               tavg: bool = False, path: str = ""):
    """(state, iterations a step) of ``nsteps`` of ``Model.advance`` under
    the path's forcing (``step_forcing``), from the model's initial state
    (its calendar reset); with ``tavg`` a third item, the averages of a
    stream of every field the configuration evaluates over those steps (it
    writes no file; the model is its own, not shared)."""
    model = Model(cfg, device=device) if tavg else _model(cfg, device)
    stream = None
    if tavg:
        stream = model.enable_tavg(probe_fields(model, None)[0],
                                   freq_steps=10 ** 9)
    state = (stratified_state(model, SEED + 7) if stratified
             else model.initial_state())
    forcing = step_forcing(path, model)
    iters = []
    for _ in range(nsteps):
        state, diags = model.advance(state, forcing(model, state))
        iters.append(int(diags.solver_iters))
    if tavg:
        return state, iters, stream.averages()
    return state, iters


def _state_diffs(a, b):
    """Each of PATH_FIELDS' largest difference over its largest value, and
    with passive tracers each of those (``tracer2`` ...) on its own scale:
    they are far smaller than T and S and do not act on the dynamics."""
    pairs = [(name, getattr(a, name), getattr(b, name))
             for name in PATH_FIELDS]
    pairs += [(f"tracer{n}", a.tracer_cur[n], b.tracer_cur[n])
              for n in range(2, a.tracer_cur.shape[0])]
    out = {}
    for name, x, y in pairs:
        y = y.to(x.device)
        if not bool(torch.isfinite(x).all() and torch.isfinite(y).all()):
            raise AssertionError(f"{name} not finite")
        out[name] = float((x - y).abs().max()) / (float(y.abs().max())
                                                  or 1.0)
    return out


def chain_plain_grouped(cfg, grid, bc, tmix, slp, sla, kv, tlt,
                        want_diags=True, sm=None):
    """``gm_chain_cuda.chain_plain`` a group of the kernel's launches at a
    time (``gm_chain_cuda.tracer_groups``; one call up to 8 tracers): the
    plain twin takes each tracer alone, so every tracer's result is the
    whole call's (tests/test_torch_bgc.py holds it bitwise), in the memory
    of a group (39 tracers at once overrun the card in float64)."""
    gtk, vdc, diags = torch.empty_like(tmix), None, None
    for g, (n0, n) in enumerate(gm_chain_cuda.tracer_groups(
            tmix.shape[0], tmix.element_size(), sm is not None)):
        part = gm_chain_cuda.chain_plain(cfg, grid, bc, tmix[n0:n0 + n], slp,
                                         sla, kv, tlt, want_diags and g == 0,
                                         sm)
        gtk[n0:n0 + n] = part[0]
        if g == 0:
            vdc, diags = part[1], part[2]
    return gtk, vdc, diags


def flux_plain_grouped(cfg, grid, bc, tx, ty, tz, *weights, cancellation,
                       kisop_y=None):
    """``gm_cuda.flux_assembly_plain`` a group at a time, as
    ``chain_plain_grouped``; ``weights``: slx, sly, sf_slx, sf_sly, kisop,
    hor_diff."""
    gtk, vdc = torch.empty_like(tx), None
    for g, (n0, n) in enumerate(gm_cuda.tracer_groups(tx.shape[0])):
        part = gm_cuda.flux_assembly_plain(
            cfg, grid, bc, tx[n0:n0 + n], ty[n0:n0 + n], tz[n0:n0 + n],
            *weights, cancellation, kisop_y=kisop_y)
        gtk[n0:n0 + n] = part[0]
        vdc = part[1] if g == 0 else vdc
    return gtk, vdc


def tracer_plain_grouped(cfg, grid, u, v, trcr, tmix, told, vdc, stf, dh):
    """``tracer_cuda.tracer_tendency_plain`` a group of
    ``gm_cuda.tracer_groups`` at a time, each tracer with its diffusivity
    class (T the first of ``vdc``, every other tracer the second)."""
    out = torch.empty_like(trcr)
    for n0, n in gm_cuda.tracer_groups(trcr.shape[0]):
        sl = slice(n0, n0 + n)
        out[sl] = tracer_cuda.tracer_tendency_plain(
            cfg, grid, u, v, trcr[sl], tmix[sl], told[sl],
            vdc if n0 == 0 else vdc[1:].expand_as(vdc), stf[sl], dh)
    return out


@contextlib.contextmanager
def plain_versions():
    """Inside the block the wrappers are replaced by their plain PyTorch
    versions, so a whole run on the card can be compared with and without
    the kernels; those of the tracer-batched kernels take a group of
    tracers at a time (``chain_plain_grouped``). The package itself has no
    such switch: its wrappers choose by the tensor's device alone."""
    def flux(*args, kisop_y=None):
        return flux_plain_grouped(*args[:-1], cancellation=args[-1],
                                  kisop_y=kisop_y)
    swaps = [(tridiag_cuda, "thomas", tridiag_cuda.thomas_plain),
             (tracer_cuda, "tracer_tendency", tracer_plain_grouped),
             (clinic_cuda, "clinic_rhs_fields", clinic_cuda.clinic_rhs_plain),
             (gm_slope_cuda, "slopes", gm_slope_cuda.slopes_plain),
             (gm_chain_cuda, "chain", chain_plain_grouped),
             (gm_tlt_cuda, "transition_layer", gm.transition_layer),
             (gm, "flux_assembly", flux)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# the paths whose kernel-vs-plain run is held in float32 too (the others in
# float64 alone, for the script's time limit)
PLAIN_F32_PATHS = ("core", "gm_full", "prod_full", "prod_bgc")


def path_vs_plain_phase(path: str, nsteps: int = 2):
    """nsteps with the kernels against nsteps with the plain versions forced,
    same initial state, at full size: float64 first, then on
    PLAIN_F32_PATHS float32, where both runs are also held against the
    float64 run (the witness that their difference is float32 rounding and
    not a fault of a kernel). The GM path starts from the stratified state,
    so that GM has slopes to work on."""
    ref = None
    stratified = path not in ("core", "core_topo")
    on_path = [k for k, v in expected_counts(path, nsteps).items() if v]
    dtypes = (("float64", "float32") if path in PLAIN_F32_PATHS
              else ("float64",))
    for dtype_name in dtypes:
        cfg = full_config(dtype_name, path)
        reset_counts()
        s_kernel, it_k = _run_steps(cfg, nsteps, stratified=stratified,
                                    path=path)
        n_kernel = read_counts()
        reset_counts()
        with plain_versions():
            s_plain, it_p = _run_steps(cfg, nsteps, stratified=stratified,
                                       path=path)
        if any(read_counts().values()) or not all(n_kernel[k]
                                                  for k in on_path):
            raise AssertionError("the comparison did not separate the "
                                 "kernel run from the plain run")
        diffs = _state_diffs(s_kernel, s_plain)
        fixed = PATH_BAND[cfg.torch_dtype]
        band = {k: fixed.get(k, fixed["tracer_cur"]) for k in diffs}
        if ref is not None:
            d_k, d_p = _state_diffs(s_kernel, ref), _state_diffs(s_plain, ref)
            if path in WITNESS_BAND_PATHS:
                band = {k: WITNESS_RATIO * d_p[k] for k in d_p}
        out = {"phase": "path_vs_plain", "path": path, "dtype": dtype_name,
               "steps": nsteps, "stratified_start": stratified,
               "rel_diff": diffs, "band": band,
               "solver_iters_kernel": it_k, "solver_iters_plain": it_p}
        broken = {k: v for k, v in diffs.items() if not v <= band[k]}
        if ref is None:
            ref = s_kernel
        else:
            out.update({"kernel_run_vs_float64": d_k,
                        "plain_run_vs_float64": d_p,
                        "witness_ratio_limit": WITNESS_RATIO})
            broken.update({k + "_vs_float64": (d_k[k], d_p[k]) for k in d_k
                           if not d_k[k] <= WITNESS_RATIO * d_p[k]})
        emit(out)
        if broken:
            raise AssertionError(f"{path} {dtype_name} path with kernels "
                                 f"differs from the plain path beyond its "
                                 f"band: {broken}")
    _MODELS.clear()


def breakdown_phase(path: str, dtype_name: str, stratified: bool = False,
                    nsteps: int = 2, nprof: int = 1):
    """Where a leapfrog step's time goes at full size, from the model's own
    initial state (rest, horizontally uniform: GM has no slopes to work on
    and its transition-layer search ends after a few levels) or from the
    stratified state, where the search runs as deep as the slopes carry the
    layer (the deepest level it reached is reported). First the three parts
    of ``step.step`` (and, on the GM paths, the parts of the GM tendency
    inside the baroclinic driver; on prod_mix also KPP and the submesoscale
    amplitudes) by the host clock with a
    synchronize around each (so the parts do not overlap and their sum
    exceeds an unsynchronized step slightly); then ``nprof`` steps under
    ``torch.profiler`` for the device's busy time and the kernels that hold
    it. The profiler adds host time to every launch, so the busy share of its
    own window is a lower bound; the device time of the profiled steps over
    the unprofiled step time is the estimate of the share in normal
    running. The transition-layer search runs as the kernel; its plain
    version is timed after the steps on the last step's inputs."""
    from torch.profiler import ProfilerActivity, profile

    from pop2_tpu_torch import barotropic

    cfg = full_config(dtype_name, path)
    model = Model(cfg)
    start = (stratified_state(model, SEED + 7) if stratified
             else model.initial_state())
    forcing = path_forcing(model)
    state = model.run(start, 3, forcing)  # past the Euler step
    spans = [("baroclinic_driver", baroclinic, "driver"),
             ("barotropic_driver", barotropic, "driver"),
             ("correct_adjust", baroclinic, "correct_adjust")]
    if path in ("gm_full", "prod_dyn", "prod_mix", "prod_full"):
        spans += [("gm_slopes_kernel", gm_slope_cuda, "slopes"),
                  ("gm_transition_layer_kernel", gm_tlt_cuda,
                   "transition_layer"),
                  ("gm_bfre_profile_plain", gm, "kappa_vertical_bfre"),
                  ("gm_chain_kernel", gm_chain_cuda, "chain")]
    if path in ("prod_mix", "prod_full"):
        spans += [("kpp_plain", kpp, "kpp_coeffs"),
                  ("submeso_amplitudes_plain", submeso, "amplitudes")]
    parts = {name: 0.0 for name, _, _ in spans}
    deepest = [0]
    search_args = []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            if isinstance(out, gm.TLT):  # read outside the timed span
                deepest[0] = max(deepest[0], int(out.k_level.max()))
                search_args[:] = [args]
            return out
        return wrapper

    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in spans]
    for (name, mod, attr), (_, _, fn) in zip(spans, saved):
        setattr(mod, attr, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 0
        for _ in range(nsteps):
            state, diags = model.advance(state, forcing)
            iters += int(diags.solver_iters)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    search = None
    if search_args:  # the last step's search, by the kernel and plain
        args = search_args[0]
        search = {
            "kernel_ms": time_ms(
                lambda: gm_tlt_cuda.transition_layer(*args), 2, 10),
            "plain_ms": time_ms(lambda: gm.transition_layer(*args), 1, 3),
            "deepest_level": int(gm.transition_layer(
                *args).k_level.max())}
        del args, search_args[:]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nprof):
            state, _ = model.advance(state, forcing)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0

    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    emit({"phase": "breakdown", "path": path, "dtype": dtype_name,
          "start": "stratified" if stratified else "rest", "steps": nsteps,
          "transition_layer_deepest_level": deepest[0] or None,
          "ms_per_step": total / nsteps * 1e3,
          "ms_per_step_by_part": {k: v / nsteps * 1e3
                                  for k, v in parts.items()},
          "solver_iters_per_step": iters / nsteps,
          "transition_layer_search_last_step": search,
          "profiled_steps": nprof,
          "profiled_ms_per_step": window / nprof * 1e3,
          "device_busy_ms_per_step": (busy_us / nprof / 1e3
                                      if busy_us else None),
          "device_busy_share_under_profiler": (busy_us / (window * 1e6)
                                               if busy_us else None),
          "device_busy_share_of_unprofiled_step": (
              busy_us / nprof / (total / nsteps * 1e6) if busy_us else None),
          "top_device_kernels_ms_per_step": [
              [ev.key[:60], ev.self_device_time_total / nprof / 1e3,
               ev.count // nprof] for ev in kernels[:10]]})


# the captured run loop's paths: (path, dtype, steps from rest); core and
# gm_full take an averaging step at 17 between captured steps, the
# production paths (the Robert filter) none; prod_vmix jumps its calendar
# halfway
RUN_LOOP = (("core", "float32", 18), ("gm_full", "float32", 18),
            ("prod_full", "float32", 4), ("prod_full", "float64", 4),
            ("prod_vmix", "float32", 8), ("prod_hmix", "float32", 4),
            ("core_topo", "float32", 4), ("prod_eg", "float32", 4),
            ("prod_aniso", "float32", 4), ("core_lw", "float32", 4),
            ("prod_pbc", "float32", 4), ("prod_forced", "float32", 4),
            ("prod_bgc", "float32", 4), ("prod_bgc", "float64", 4),
            ("prod_file", "float32", 4))
RUN_LOOP_MORE = 2  # steps more, captured alone, for steps/s and the audit
RESTART_STEPS = 2  # prod_full float32: 2 + write + read + 2 against 4


@contextlib.contextmanager
def solver_iterations():
    """Inside the block each solve's iteration count is appended to the
    list it yields: the eager and the captured step both run
    ``solvers.Solver.run``."""
    log = []
    run = solvers.Solver.run

    def logged(self, carry, advance=None):
        out = run(self, carry, advance)
        log.append(out[1])
        return out
    solvers.Solver.run = logged
    try:
        yield log
    finally:
        solvers.Solver.run = run


def sync_points(fn):
    """(fn(), {"file:line": count} of the host-device synchronizations it
    made), by torch's sync debug mode; each named by the innermost frame
    of this repository's code (the port's or this script's)."""
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "pop2_tpu_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        f = frames[-1] if frames else None
        if f is not None and f.name == "sync_points":
            return  # switching the debug mode on, not fn
        where[f"{os.path.basename(f.filename)}:{f.lineno}" if f
              else f"{os.path.basename(filename)}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, dict(where)


def solver_read_lines():
    """The solver loop's host reads (``Solver.run``'s ``float(carry[...])``
    lines) as "solvers.py:line"."""
    lines, first = inspect.getsourcelines(solvers.Solver.run)
    return {f"solvers.py:{first + i}" for i, line in enumerate(lines)
            if "float(carry[" in line}


def _timed(fn):
    """(fn(), seconds, launch counts, peak device memory) with the counts
    and the peak reset just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, read_counts(),
            torch.cuda.max_memory_allocated())


def _device_busy(fn, nsteps: int):
    """(device kernel ms a step, busy share of the window) of ``nsteps``
    steps under torch.profiler (``_device_split``); (None, None) if it saw
    no kernel."""
    split = _device_split(fn, nsteps)
    if split is None:
        return None, None
    return split["kernel_ms"], split["busy_share"]


def _union_us(intervals) -> float:
    """The time that at least one of the (start, end) intervals covers."""
    total, reached = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > reached:
            total += b - max(a, reached)
            reached = b
    return total


def _device_split(fn, nsteps: int):
    """The device's work in ``nsteps`` steps under torch.profiler, a step:
    {"kernels": launches, "kernel_ms": their summed time, "copy_kernels",
    "copy_ms": those of copy kernels (an exchange's pieces, a stack, a
    cat, a pad), "busy_ms": the time at least one kernel ran (the union of
    their intervals), "window_ms": the host clock's}, with "busy_share" =
    busy_ms / window_ms and "kernel_overlap" = kernel_ms / window_ms (above
    1 where kernels of several streams ran at once); None if it saw no
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out = dict.fromkeys(("kernels", "kernel_ms", "copy_kernels",
                         "copy_ms"), 0.0)
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        out["kernels"] += 1
        out["kernel_ms"] += (end - start) / 1e3
        if re.search(r"copy|Copy|cat|Cat|pad|Memcpy", ev.name):
            out["copy_kernels"] += 1
            out["copy_ms"] += (end - start) / 1e3
    if not spans:
        return None
    out["busy_ms"] = _union_us(spans) / 1e3
    out = {k: v / nsteps for k, v in out.items()}
    out["window_ms"] = 1e3 * window / nsteps
    out["busy_share"] = out["busy_ms"] / out["window_ms"]
    out["kernel_overlap"] = out["kernel_ms"] / out["window_ms"]
    return out


def _leaf_spread(a, b):
    """{leaf: max |a - b|} of two states."""
    return {name: float((x - getattr(b, name)).abs().max())
            for name, x in a.leaves()}


def run_loop_phase(path: str, dtype_name: str, nsteps: int):
    """``Model.run_compiled`` (CUDA graphs of the step's segments) against
    ``Model.run`` (eager ``advance``) from one state at full size: two
    eager runs give the eager-against-eager spread, and the captured run
    must equal the first bitwise or lie inside that spread on every state
    leaf, with equal iterations per step, equal launch counts and at least
    one replay. The eager run's host-device synchronizations, and those of
    captured steps after the capture, must all be the solver's convergence
    reads. Then steps/s, the device's busy share, capture seconds, graphs
    and peak device memory of both. Under the lunar cycle the eager and the
    captured run jump the calendar by LUNAR_JUMP_YEARS halfway, one step a
    call, and the captured step's static lunar buffer must hold the
    calendar's factor of each captured step."""
    t_phase = time.perf_counter()
    cfg = full_config(dtype_name, path)
    model = Model(cfg)
    allowed = solver_read_lines()
    start = model.initial_state()
    # one forcing for the run (prod_forced's composed from the start, every
    # field of its menu set)
    forcing = step_forcing(path, model)(model, start)
    lunar = model._lnc is not None
    lunar_log = []  # (the static buffer after a captured step, the factor)

    def rewind(n=0):
        model.nsteps_total = n
        model.time_manager.reset()

    def steps(state, n, compiled):
        if not (lunar and n == nsteps):
            return (model.run_compiled(state, n, forcing)[0] if compiled
                    else model.run(state, n, forcing))
        for i in range(n):
            if i == n // 2:
                model.time_manager.calendar.iyear += LUNAR_JUMP_YEARS
            want = model.lunar_factor()
            if not compiled:
                state = model.run(state, 1, forcing)
                continue
            state, _ = model.run_compiled(state, 1, forcing)
            if model._captured is not None:
                lunar_log.append((model._captured.forcing.tidal_lnc.clone(),
                                  want))
        return state

    def eager(state=start, n=nsteps):
        with solver_iterations() as iters:
            state = steps(state, n, False)
        return state, list(iters)

    def compiled(state=start, n=nsteps):
        with solver_iterations() as iters:
            state = steps(state, n, True)
        return state, list(iters)

    parts = {"model": time.perf_counter() - t_phase}
    # the first eager run fills the grid's caches; the second is audited
    rewind()
    (s_eager, it_eager), t_eager, n_eager, mem_eager = _timed(eager)
    rewind()
    (s_again, _), syncs_eager = sync_points(eager)
    spread = _leaf_spread(s_eager, s_again)
    del s_again
    # eager steps past the run, for steps/s (before the graphs hold their
    # pools: prod_bgc's float64 eager step does not fit beside them)
    rewind(nsteps)
    _, t_more_eager, _, _ = _timed(lambda: eager(s_eager, RUN_LOOP_MORE))
    parts["eager_runs"] = time.perf_counter() - t_phase - parts["model"]
    # the eager runs' cached blocks back to the card: the graphs' private
    # pools cannot use them (prod_bgc in float64 needs the room)
    torch.cuda.empty_cache()
    rewind()
    (s_comp, it_comp), t_comp, n_comp, mem_comp = _timed(compiled)
    cap = model._captured
    if cap is None or not cap.replays:
        raise AssertionError(f"{path} {dtype_name}: run_compiled replayed "
                             "no graph")
    # steps past the run, each captured: the audit, then steps/s
    (s_more, _), syncs_comp = sync_points(
        lambda: compiled(s_comp, RUN_LOOP_MORE))
    _, t_more_comp, _, _ = _timed(lambda: compiled(s_more, RUN_LOOP_MORE))
    # the device time of a step, under the profiler; the eager step runs
    # the same kernels (its state is bitwise the same), so its busy share
    # is that time over its own step time
    t0 = time.perf_counter()
    rewind(nsteps)
    device_ms, busy_profiled = _device_busy(lambda: compiled(s_comp, 1), 1)
    parts["profiled"] = time.perf_counter() - t0

    diff = _leaf_spread(s_comp, s_eager)
    bitwise = all(torch.equal(x, getattr(s_eager, n))
                  for n, x in s_comp.leaves())
    stray = {k: v for k, v in {**syncs_eager, **syncs_comp}.items()
             if k not in allowed}
    n_avg = sum(model.step_flags(n)[1] for n in range(1, nsteps + 1))
    out = {"phase": "run_loop", "path": path, "dtype": dtype_name,
           "dims": [cfg.nx, cfg.ny, cfg.km], "steps": nsteps,
           "averaging_steps": n_avg,
           "bitwise_equal_to_advance": bitwise,
           "eager_vs_eager_max_abs": max(spread.values()),
           "captured_vs_eager_max_abs": max(diff.values()),
           "leaves_outside_spread": [k for k in diff
                                     if diff[k] > spread[k]],
           "solver_iters_eager": it_eager, "solver_iters_captured": it_comp,
           "launches_eager": n_eager, "launches_captured": n_comp,
           "graphs": cap.graphs, "replays": cap.replays,
           "capture_seconds": cap.capture_seconds,
           "seconds_eager": t_eager, "seconds_captured": t_comp,
           "steps_per_s_eager": nsteps / t_eager,
           "steps_per_s_captured_run": nsteps / t_comp,
           "steps_per_s_leapfrog_eager": RUN_LOOP_MORE / t_more_eager,
           "steps_per_s_leapfrog_captured": RUN_LOOP_MORE / t_more_comp,
           "device_ms_per_step": device_ms,
           "device_busy_share_captured_under_profiler": busy_profiled,
           "device_busy_share_captured": (
               device_ms * RUN_LOOP_MORE / (t_more_comp * 1e3)
               if device_ms else None),
           "device_busy_share_eager": (
               device_ms * RUN_LOOP_MORE / (t_more_eager * 1e3)
               if device_ms else None),
           "peak_device_mem_bytes_eager": mem_eager,
           "peak_device_mem_bytes_captured": mem_comp,
           "sync_points_eager": syncs_eager,
           "sync_points_captured": syncs_comp,
           "sync_points_allowed": sorted(allowed)}
    if path == "prod_full" and dtype_name == "float32":
        t0 = time.perf_counter()
        out["restart"] = restart_round_trip(model, forcing)
        parts["restart"] = time.perf_counter() - t0
    if path == "prod_forced":
        t0 = time.perf_counter()
        out["rebuild"] = rebuild_check(model, s_comp, forcing, nsteps)
        parts["rebuild"] = time.perf_counter() - t0
    if lunar:
        got = [float(b) for b, _ in lunar_log]
        want = [float(torch.tensor(w, dtype=cfg.torch_dtype))
                for _, w in lunar_log]
        out["lunar"] = {"jump_years": LUNAR_JUMP_YEARS,
                        "captured_steps": len(got), "buffer": got,
                        "calendar": want, "equal": got == want}
    out["phase_seconds"] = {**parts, "total": time.perf_counter() - t_phase}
    emit(out)
    broken = []
    if lunar and not (out["lunar"]["equal"] and len(got) >= 2
                      and max(want) - min(want) > 1e-3):
        broken.append("the captured step's lunar factor is not the "
                      "calendar's at every step, or did not move")
    if not bitwise and out["leaves_outside_spread"]:
        broken.append("state leaves outside the eager spread")
    if it_eager != it_comp:
        broken.append("iterations per step")
    if n_eager != n_comp:
        broken.append("launch counts")
    if stray:
        broken.append(f"host reads outside the solver's checks {stray}")
    if path == "prod_full" and dtype_name == "float32" \
            and not out["restart"]["equal"]:
        broken.append("restart round trip")
    if path == "prod_forced" and not (out["rebuild"]["rebuilt"]
                                      and out["rebuild"]["equal"]):
        broken.append(f"rebuild for another forcing structure "
                      f"{out['rebuild']}")
    if broken:
        raise AssertionError(f"run_loop {path} {dtype_name}: "
                             + "; ".join(broken))
    return {"launches": n_comp, "replays": cap.replays,
            "steps_per_s_leapfrog_captured": RUN_LOOP_MORE / t_more_comp,
            "device_ms_per_step": device_ms,
            "peak_device_mem_bytes_captured": mem_comp}


# tavg_phase: the interval of its stream (steps), and the paths and dtypes
# it runs (prod_full's 4 steps and TAVG_MORE more, the second write among
# them)
TAVG_FREQ = 4
TAVG_MORE = 4
TAVG = (("prod_full", "float32", 4), ("prod_full", "float64", 4))


def probe_fields(model, forcing):
    """(the registered tavg fields the model's configuration evaluates,
    {field: error} of those that raise), from the extras of one eager Euler
    step from the model's initial state."""
    from pop2_tpu_torch import step as step_mod, tavg
    forcing = forcing or model.forcing
    new, _, extras = step_mod.step(
        model.cfg, model.grid, model.bc, model.ts_range,
        model.initial_state(), forcing, False, False,
        **model.step_args(False), with_extras=True)
    aux = tavg.TavgAux(forcing=forcing, bc=model.bc, **extras)
    ok, raising = [], {}
    for name, d in tavg.FIELDS.items():
        try:
            d.fn(model.cfg, model.grid, new, aux)
        except (ValueError, NotImplementedError) as err:
            raising[name] = str(err)[:160]
            continue
        ok.append(name)
    return ok, raising


def tavg_write_lines():
    """The stream write's one device read (``tavg._np``'s copy to the host)
    as "tavg.py:line"."""
    from pop2_tpu_torch import tavg
    lines, first = inspect.getsourcelines(tavg._np)
    return {f"tavg.py:{first + i}" for i, line in enumerate(lines)
            if '.to("cpu"' in line}


def check_tavg_file(fname, stream, snapshot):
    """The written NetCDF3 file re-read with scipy: every variable of the
    stream present and finite, each equal to the accumulator buffer
    ``snapshot`` = (nsamples, buffer) over nsamples (the minima and maxima
    as they are) in float32, and the file under the classic format's
    2 GiB offset limit. Returns (bytes, seconds to read and check)."""
    from scipy.io import netcdf_file
    from pop2_tpu_torch import tavg
    t0 = time.perf_counter()
    size = os.path.getsize(fname)
    if size >= 2 ** 31:
        raise AssertionError(f"{fname}: {size} bytes, beyond NetCDF3 "
                             "classic's 2 GiB offsets")
    nsamples, buf = snapshot
    host = buf.cpu().numpy()
    with netcdf_file(fname, mmap=False) as f:
        missing = [n for n in stream.contents if n not in f.variables]
        if missing or len(f.variables) != len(stream.contents) + 4:
            raise AssertionError(f"{fname}: variables missing {missing}")
        for name in stream.contents:
            lo, hi, shape = stream._spans[name]
            a = host[lo:hi].reshape(shape)
            if tavg.FIELDS[name].method == "avg":
                a = a * (1.0 / nsamples)
            got = f.variables[name][:][0]
            if not np.isfinite(got).all():
                raise AssertionError(f"{fname}: {name} not finite")
            if not np.array_equal(got, a.astype(np.float32)):
                raise AssertionError(f"{fname}: {name} is not the "
                                     "accumulators over nsamples")
    return size, time.perf_counter() - t0


def tavg_phase(path: str, dtype_name: str, nsteps: int, no_stream: dict):
    """``Model.run_compiled`` with one step-frequency tavg stream of every
    field the configuration evaluates (interval TAVG_FREQ) against
    ``Model.run`` (eager ``advance``), from one state at full size,
    ``nsteps`` + TAVG_MORE steps: every accumulator at each write and
    the state bitwise equal, iterations equal, launch counts equal (the
    chain kernel with its diagnostic columns and the flux assembly's
    tripole row once a step, the search kernel twice: in the step and in
    HDIFT/HDIFS's GM), host reads of captured steps only the solver's and
    one a stream write, the file of that write re-read against the
    accumulators (the other files are deleted as they are written). Then
    captured steps/s with the stream beside ``no_stream`` (run_loop_phase's
    of this call), device ms a step, the accumulation's device ms, capture
    seconds, graphs and peak memory; the steps/s between two writes, the
    write's seconds apart. Returns the captured run's launches."""
    from pop2_tpu_torch import step as step_mod, tavg
    t_phase = time.perf_counter()
    cfg = full_config(dtype_name, path)
    model = Model(cfg)
    forcing = path_forcing(model)
    fields, raising = probe_fields(model, forcing)
    reads = solver_read_lines()
    writes = tavg_write_lines()
    start = model.initial_state()
    tmp = tempfile.TemporaryDirectory()
    stream = model.enable_tavg(fields, freq_steps=TAVG_FREQ,
                               outdir=tmp.name)
    snaps, write_s, files = [], [], []
    write = stream.write

    def write_and_keep(out, step_number=0):
        """The stream's write, with a device copy of the accumulators it
        wrote; the file is kept for ``check_tavg_file`` while ``files`` is
        empty, else deleted at once."""
        snaps.append((stream.nsamples, stream.buffer.clone()))
        t0 = time.perf_counter()
        fname = write(out, step_number)
        write_s.append(time.perf_counter() - t0)
        if keep_file[0]:
            files.append((fname, snaps[-1]))
            keep_file[0] = False
        else:
            os.remove(fname)
        return fname
    keep_file = [False]
    stream.write = write_and_keep

    def rewind(n=0):
        model.nsteps_total = n
        model.time_manager.reset()
        stream.reset()

    def eager(state=start, n=nsteps):
        with solver_iterations() as iters:
            state = model.run(state, n, forcing)
        return state, list(iters)

    def compiled(state=start, n=nsteps):
        with solver_iterations() as iters:
            state, _ = model.run_compiled(state, n, forcing)
        return state, list(iters)

    parts = {"model_and_probe": time.perf_counter() - t_phase}
    rewind()
    (s_e, it_e), t_e, n_e, mem_e = _timed(eager)
    (s_e, it_e2), t_more_e, _, _ = _timed(lambda: eager(s_e, TAVG_MORE))
    snaps_eager, w_eager = list(snaps), sum(write_s)
    snaps.clear()
    write_s.clear()
    parts["eager_runs"] = time.perf_counter() - t_phase \
        - parts["model_and_probe"]
    rewind()
    (s_c, it_c), t_c, n_c, mem_c = _timed(compiled)
    cap = model._captured
    if cap is None or not cap.replays:
        raise AssertionError(f"tavg {path} {dtype_name}: run_compiled "
                             "replayed no graph")
    # steps past the run, captured, with one write (whose file is kept)
    keep_file[0] = True
    (s_c, it_c2), syncs = sync_points(lambda: compiled(s_c, TAVG_MORE))
    n_writes_audited = 1
    n_snaps = len(snaps)
    bitwise_acc = n_snaps == len(snaps_eager) and all(
        a[0] == b[0] and torch.equal(a[1], b[1])
        for a, b in zip(snaps, snaps_eager))
    bitwise_state = all(torch.equal(x, getattr(s_e, n))
                        for n, x in s_c.leaves())
    del snaps_eager
    t0 = time.perf_counter()
    checked = [check_tavg_file(fname, stream, snap)
               for fname, snap in files]
    for fname, _ in files:
        os.remove(fname)
    snaps.clear()
    parts["file_check"] = time.perf_counter() - t0
    # captured steps/s with the stream between two writes (steps 13-15),
    # then the step that writes, then one under the profiler
    n_between = TAVG_FREQ - 1
    _, t_more_c, _, _ = _timed(lambda: compiled(s_c, n_between))
    write_s.clear()
    compiled(s_c, 1)
    w_more = sum(write_s)
    snaps.clear()
    t0 = time.perf_counter()
    device_ms, busy = _device_busy(lambda: compiled(s_c, 1), 1)
    # the accumulation alone: one sample from an eager step's extras
    new, _, extras = step_mod.step(
        cfg, model.grid, model.bc, model.ts_range, s_c, forcing
        or model.forcing, True, False, **model.step_args(True),
        with_extras=True)
    aux = tavg.TavgAux(forcing=forcing or model.forcing, bc=model.bc,
                       **extras)
    stream.accumulate_fields(new, aux)  # warm
    reset_counts()
    acc_ms, _ = _device_busy(lambda: stream.accumulate_fields(new, aux), 1)
    acc_counts = read_counts()
    parts["profiled"] = time.perf_counter() - t0
    del new, extras, aux
    tmp.cleanup()

    total = nsteps + TAVG_MORE
    stray = {k: v for k, v in syncs.items() if k not in reads | writes}
    n_write_reads = sum(v for k, v in syncs.items() if k in writes)
    per_step = {k: n_c[k] / nsteps for k in ("gm_chain", "gm_chain_diags",
                                             "gm_flux", "gm_flux_fold",
                                             "gm_tlt", "gm_slope")}
    out = {"phase": "tavg", "path": path, "dtype": dtype_name,
           "dims": [cfg.nx, cfg.ny, cfg.km], "nt": cfg.nt,
           "steps": [nsteps, TAVG_MORE], "freq_steps": TAVG_FREQ,
           "fields": len(fields),
           "fields_3d": sum(tavg.FIELDS[n].ndims == 3 for n in fields),
           "fields_raising": raising,
           "accumulator_bytes": stream.buffer.numel()
           * stream.buffer.element_size(),
           "writes_compared": n_snaps,
           "accumulators_bitwise_equal_to_advance": bitwise_acc,
           "state_bitwise_equal_to_advance": bitwise_state,
           "solver_iters_eager": it_e + it_e2,
           "solver_iters_captured": it_c + it_c2,
           "launches_eager": n_e, "launches_captured": n_c,
           "launches_per_step": per_step,
           "accumulation_launches": acc_counts,
           "files_checked": [{"bytes": b, "seconds": sec}
                             for b, sec in checked],
           "write_seconds_eager": w_eager,
           "graphs": cap.graphs, "replays": cap.replays,
           "capture_seconds": cap.capture_seconds,
           "seconds_eager": t_e, "seconds_captured": t_c,
           "steps_per_s_leapfrog_eager_with_a_write": TAVG_MORE
           / t_more_e,
           "steps_per_s_leapfrog_captured": n_between / t_more_c,
           "device_busy_share_captured": (device_ms * n_between
                                          / (t_more_c * 1e3)
                                          if device_ms else None),
           "write_seconds": w_more,
           "steps_per_s_leapfrog_captured_no_stream": no_stream.get(
               "steps_per_s_leapfrog_captured"),
           "device_ms_per_step": device_ms,
           "device_ms_per_step_no_stream": no_stream.get(
               "device_ms_per_step"),
           "device_busy_share_captured_under_profiler": busy,
           "accumulation_device_ms": acc_ms,
           "peak_device_mem_bytes_eager": mem_e,
           "peak_device_mem_bytes_captured": mem_c,
           "peak_device_mem_bytes_captured_no_stream": no_stream.get(
               "peak_device_mem_bytes_captured"),
           "sync_points_captured": syncs,
           "sync_points_allowed": sorted(reads | writes),
           "stream_write_reads": n_write_reads,
           "stream_writes_audited": n_writes_audited,
           "phase_seconds": {**parts,
                             "total": time.perf_counter() - t_phase}}
    emit(out)
    broken = []
    if raising:
        broken.append(f"fields raising {sorted(raising)}")
    if n_snaps != total // TAVG_FREQ or not bitwise_acc:
        broken.append("accumulators differ from advance's")
    if not bitwise_state:
        broken.append("state differs from advance's")
    if it_e + it_e2 != it_c + it_c2:
        broken.append("iterations per step")
    if n_e != n_c:
        broken.append("launch counts")
    want = {"gm_chain": 1, "gm_chain_diags": 1, "gm_flux": 1,
            "gm_flux_fold": 1, "gm_tlt": 2, "gm_slope": 1}
    if per_step != want:
        broken.append(f"launches a step {per_step}, expected {want}")
    if stray or n_write_reads > n_writes_audited:
        broken.append(f"host reads beyond the solver's and one a write "
                      f"{syncs}")
    if len(checked) != 1:
        broken.append("the written file was not checked")
    if broken:
        raise AssertionError(f"tavg {path} {dtype_name}: "
                             + "; ".join(broken))
    return {"launches": n_c, "replays": cap.replays}


def rebuild_check(model, state, forcing, nsteps: int):
    """Two steps of ``run_compiled`` from ``state`` (after ``nsteps``)
    under ``forcing`` without its chlorophyll and runoff, another set of
    tensor fields: the captured step must be built again (a new
    ``CapturedStep`` whose forcing buffers lack the two fields, captured
    and replayed) and the state must equal two steps of ``advance``
    bitwise."""
    from pop2_tpu_torch import graphs
    other = forcing.replace(chl=None, roff_f=None)
    model.time_manager.reset()
    model.nsteps_total = nsteps
    eager = model.run(state, 2, other)
    model.time_manager.reset()
    model.nsteps_total = nsteps
    first = model._captured
    got, _ = model.run_compiled(state, 2, other)
    new = model._captured
    diff = _leaf_spread(got, eager)
    dropped = sorted(graphs.structure(first.forcing)
                     - graphs.structure(new.forcing))
    return {"steps": 2, "new_captured_step": new is not first,
            "fields_dropped": dropped, "graphs": new.graphs,
            "replays": new.replays,
            "rebuilt": (new is not first and dropped == ["chl", "roff_f"]
                        and new.replays > 0),
            "equal": all(v == 0.0 for v in diff.values()),
            "max_abs": max(diff.values())}


def restart_round_trip(model, forcing):
    """RESTART_STEPS captured steps, a checkpoint written and read back,
    RESTART_STEPS more, against 2 RESTART_STEPS straight: every leaf equal
    (bitwise, or within the eager spread of the caller's check)."""
    from pop2_tpu_torch.io import restart
    straight, _ = model.run_compiled(model.initial_state(),
                                     2 * RESTART_STEPS, forcing)
    half, _ = model.run_compiled(model.initial_state(), RESTART_STEPS,
                                 forcing)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        restart.write_restart(os.path.join(tmp, "ckpt"), half,
                              model.nsteps_total, model.cfg,
                              compressed=False)
        t_write = time.perf_counter() - t0
        back, nsteps = restart.read_restart(tmp, model.cfg)
    model.initial_state()
    model.nsteps_total = nsteps
    resumed, _ = model.run_compiled(back, RESTART_STEPS, forcing)
    diff = _leaf_spread(resumed, straight)
    return {"steps": [RESTART_STEPS, RESTART_STEPS],
            "equal": all(v == 0.0 for v in diff.values()),
            "max_abs": max(diff.values()), "write_seconds": t_write}


def small_vs_cpu_phase(path: str, nsteps: int = 5):
    """The GPU path (kernels) against the CPU path (plain versions) on the
    small 'mini' grid in float64: the parity band of the step-5 test (over
    ``nsteps`` steps). The GM
    path starts from the stratified state."""
    small = BGC_SMALL if path == "prod_bgc" else PROD_SMALL
    if path == "prod_file":
        cfg = get_config("prod_full", **gx_files(*GX_SMALL))
    else:
        cfg = path_config(get_config("prod_full", **PATHS[path], **small)
                          if path in PROD_PATHS
                          else get_config("mini", **PATHS[path]), path)
    stratified = path not in ("core", "core_topo")
    tavg = path == "core"  # with a tavg stream on 'mini'
    reset_counts()
    s_gpu, it_g, *av_g = _run_steps(cfg, nsteps, DEV, stratified, tavg,
                                    path)
    counts = read_counts()
    s_cpu, it_c, *av_c = _run_steps(cfg, nsteps, torch.device("cpu"),
                                    stratified, tavg, path)
    _MODELS.clear()
    if read_counts() != counts:
        raise AssertionError("the CPU run launched a kernel")
    diffs = _state_diffs(s_gpu, s_cpu)
    out = {"phase": "small_vs_cpu", "path": path,
           "dims": [cfg.nx, cfg.ny, cfg.km], "dtype": cfg.dtype,
           "steps": nsteps, "stratified_start": stratified,
           "rel_diff": diffs, "band": 1e-7, "launches_gpu": counts,
           "solver_iters_gpu": it_g, "solver_iters_cpu": it_c}
    broken = {k: v for k, v in diffs.items() if not v <= 1e-7}
    if tavg:
        # each field's average, over its scale on the CPU
        av_g, av_c = av_g[0], av_c[0]
        tavg_diffs = {n: float(np.abs(av_g[n] - a).max()
                               / (np.abs(a).max() or 1.0))
                      for n, a in av_c.items()}
        worst = max(tavg_diffs, key=tavg_diffs.get)
        out.update(tavg_fields=len(av_c), tavg_worst_field=worst,
                   tavg_worst_rel_diff=tavg_diffs[worst])
        broken.update({f"tavg {n}": v for n, v in tavg_diffs.items()
                       if not v <= 1e-7})
    emit(out)
    if broken:
        raise AssertionError(f"GPU and CPU paths differ: {broken}")


def _scale_err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero), ``want``
    moved to ``got``'s device."""
    want = want.to(got.device)
    return float((got - want).abs().max()) / (float(want.abs().max())
                                               or 1.0)


def forcing_phase(captured: dict, n_timed: int = 10):
    """Every ported forcing function at prod_forced's full size on the card
    against the same function on the CPU, in float64, each output within
    FORCING_BAND of its scale: the monthly climatology ('nearest',
    'linear', '4point', hours across the year's wrap and negative), a time
    series (both tax modes), the wind stress of a file on the tripole grid,
    the surface restoring, ``sen_lat_flux``, ``bulk_ncep``,
    ``barnier_restoring``, ``set_sfwf`` (restoring; bulk-NCEP with
    ``lfw_as_salt_flx`` and without), ``ms_balancing``, ``river_vsf``,
    ``ebm_solve`` (both branches of its cubic), ``exchange_circulation``
    with its interface flux, ``import_mcog`` (five columns in three bins),
    a running mean, a hydrographic section, and the whole composed forcing
    of a step (``ForcedForcing``). Then the time of building one step's
    forcing (CUDA events around each build, the median of ``n_timed``) in
    float32 and float64, and its share of a captured prod_forced step
    (``captured``: run_loop_phase's result in float32)."""
    t_phase = time.perf_counter()
    cfg = full_config("float64", "prod_forced")
    model = Model(cfg)
    gpu = model.grid
    cpu = gpu.to("cpu")
    rng = np.random.RandomState(SEED + 43)
    state = initial_state(cfg, gpu, DEV, passive=model.passive)
    tr = state.tracer_cur.double().cpu().numpy()
    clim = sample.forcing_climatology(
        gpu.kmask_t.cpu().numpy(), gpu.TLAT.double().cpu().numpy(),
        tr[0, 0], tr[1, 0], SEED + 41)
    shape = (cfg.ny, cfg.nx)
    month = {k: clim[k][7] for k in FORCED_CLIMS}
    sst, sss = tr[0, 0], tr[1, 0]
    tau = np.where(rng.rand(*shape) < 0.2, 0.0, 30.0 * 86400.0)
    mcog_frac = rng.rand(5, *shape)
    mcog_frac /= mcog_frac.sum(axis=0) * rng.uniform(0.9, 1.1, shape)
    mcog_fracr = mcog_frac * rng.uniform(0.5, 1.0, mcog_frac.shape)
    mcog_q = 200.0 * mcog_fracr * rng.rand(*mcog_frac.shape)
    ebm = dict(q_river=10.0 ** rng.uniform(0.0, 5.0, shape),
               tide_amp=rng.uniform(0.2, 3.0, shape),
               s_lower=rng.uniform(5.0, 35.0, shape),
               w_h=rng.uniform(500.0, 5000.0, shape),
               h=rng.uniform(5.0, 20.0, shape),
               a2=rng.uniform(-1.0, 1.0, shape))
    mask = gpu.kmask_t.cpu().numpy()
    tr3 = np.stack([(10.0 + rng.randn(*mask.shape)) * mask,
                    (0.034 + 1e-3 * rng.randn(*mask.shape)) * mask])
    years = np.array([1850.0, 1900.0, 1950.0, 2000.0])
    series = rng.rand(4, *shape)
    ws = wind_file(cfg, clim["taux"], clim["tauy"])
    points = [(-30.0, 20.0), (0.0, 100.0), (40.0, -60.0), (60.0, 300.0)]

    def cases(grid):
        dev = grid.KMT.device
        c = cfg.with_(sfwf_restore_tau=30.0)

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)
        out = {}
        for interp in ("nearest", "linear", "4point"):
            mc = forcing_tools.MonthlyClimatology.create(clim["sst"], interp,
                                                         device=dev)
            out[f"climatology_{interp}"] = [
                mc.at(h) for h in (0.0, 300.0, 8700.0, -500.0, 20000.0)]
        ts = forcing_tools.TimeSeries.create(years, series, device=dev)
        out["time_series"] = [ts.at(y, m) for y in (1800.0, 1923.0, 2050.0)
                              for m in ("extend", "extrapolate")]
        base = forcing_mod.analytic_forcing(cfg, grid)
        f = forcing_mod.file_wind_stress(
            cfg, grid, base, *forcing_mod.read_ws_file(ws, *shape),
            torch.tensor(5000.0))
        out["file_wind_stress"] = [f.smf, f.smft]
        out["restoring_forcing"] = [forcing_mod.restoring_forcing(
            cfg, grid, base, t(month["sst"]), t(month["sss"]), t(sst),
            t(sss)).stf]
        data = {k: t(v) for k, v in month.items()}
        out["sen_lat_flux"] = list(forcing_shf.sen_lat_flux(
            data["windspd"], t(sst), data["tair"], data["qair"]))
        out["bulk_ncep"] = list(forcing_shf.bulk_ncep(cfg, grid, t(sst),
                                                      data))
        out["barnier_restoring"] = list(forcing_shf.barnier_restoring(
            cfg, grid, t(sst), data["sst"], t(tau), data["qsw"]))
        for name, over in (("restoring", dict(sfwf_formulation="restoring")),
                           ("bulk_salt_flux", dict(lfw_as_salt_flx=True)),
                           ("bulk_freshwater", {})):
            o = forcing_sfwf.set_sfwf(
                c.with_(**over), grid, data["sss"], t(sss), sst_surf=t(sst),
                qlat=out["sen_lat_flux"][1], precip_data=data["precip"],
                ocn_wgt=grid.RCALCT, mask_sr=t(1.0 - clim["ms_mask"]))
            out[f"set_sfwf_{name}"] = list(o)
        region = ms_balance.build_region(grid, clim["ms_mask"],
                                         clim["ms_points"])
        out["ms_balancing"] = [ms_balance.ms_balancing(
            cfg, grid, data["precip"], [region])]
        out["river_vsf"] = [estuary.river_vsf(cfg, grid, t(clim["roff"]),
                                              t(sss))]
        # the box model at the path's river points, with the config's
        # estuary parameters and the surface salinity as the lower layer's
        out["ebm_solve"] = list(estuary.ebm_solve(
            t(clim["roff"]) * const.FWMASS_TO_FWFLUX * grid.TAREA * 1.0e-6,
            cfg.est_tide_amp, t(sss) * const.SALT_TO_PPT,
            cfg.est_mouth_width, cfg.est_mouth_depth, cfg.est_length_a1,
            cfg.est_tidal_pump_a2, cfg.est_lower_depth_ratio))
        # and on seeded inputs that reach both branches of its cubic (held
        # apart: near a double root the roots are ill-conditioned)
        eb = {k: t(v) for k, v in ebm.items()}
        coef = estuary.ebm_coefficients(**eb, a1=0.876, h0=0.5)
        disc = estuary.cubic_discriminant(*coef[3:])[2]
        branches = estuary.ebm_solve(**eb, a1=0.876, h0=0.5)
        out["ebm_branches"] = [(disc > 0).double(), (disc <= 0).double()]
        w = estuary.device_layer_weights(cfg, grid, torch.float64)
        out["exchange_circulation"] = list(estuary.exchange_circulation(
            cfg, grid, t(tr3), t(clim["roff"]), *w, want_flux=True))
        bins = mcog.import_mcog(t(mcog_frac), t(mcog_fracr), t(mcog_q),
                                t(mcog_q.sum(axis=0)), grid.KMT,
                                col_to_bin=(0, 0, 1, 2, 2), debug=True)
        out["import_mcog"] = [b for b in bins if b is not None]
        rm = running_mean.RunningMeans(cfg.time.dtt)
        rm.define("sst", 5 * 86400.0, t(sst))
        out["running_mean"] = [rm.update("sst", data["sst"])]
        sec = samplers.HydroSection(grid, points)
        st = state.to(dev).replace(tracer_cur=t(tr3))
        out["hydro_section"] = list(sec.sample(st).values())
        comp = ForcedForcing(cfg, grid, model.passive)
        out["composed_forcing"] = [v for _, v in comp.compose(
            cfg, grid, base, st, 1000.0).leaves()]
        return (out, int((disc > 0).sum()), int((disc <= 0).sum()),
                comp.river_points, branches)

    got, n_one, n_three, rivers, g_br = cases(gpu)
    want, _, _, _, w_br = cases(cpu)
    errs = {name: max(_scale_err(g, w) for g, w in zip(got[name],
                                                        want[name]))
            for name in want}
    if not (n_one and n_three):
        raise AssertionError(f"ebm_solve reached one branch only: "
                             f"{n_one} one-root, {n_three} three-root points")
    branches = ebm_conditioning(ebm, g_br, w_br)

    # the build of a step's forcing, and its share of a captured step
    timing = {}
    for dtype_name in ("float32", "float64"):
        m = Model(full_config(dtype_name, "prod_forced"))
        comp = ForcedForcing(m.cfg, m.grid, m.passive)
        st = m.initial_state()
        timing[dtype_name] = time_ms(lambda: comp(m, st), 2, n_timed)
        del m, comp, st
    step_ms = 1e3 / captured["steps_per_s_leapfrog_captured"]
    out = {"phase": "forcing", "path": "prod_forced",
           "dims": [cfg.nx, cfg.ny, cfg.km], "dtype": "float64",
           "gpu_vs_cpu_rel_err": errs, "band": FORCING_BAND,
           "worst": max(errs, key=errs.get),
           "ebm_points_one_root": n_one, "ebm_points_three_roots": n_three,
           "ebm_solve_both_branches": branches,
           "river_points": rivers,
           "build_ms": timing,
           "captured_step_ms_float32": step_ms,
           "captured_step_device_ms_float32": captured["device_ms_per_step"],
           "build_share_of_captured_step_float32": (
               timing["float32"] / step_ms),
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    broken = {k: v for k, v in errs.items() if not v <= FORCING_BAND}
    if not branches["within_conditioning"]:
        broken["ebm_solve_both_branches"] = branches
    if broken:
        raise AssertionError(f"forcing functions on the GPU differ from the "
                             f"CPU beyond {FORCING_BAND}: {broken}")
    return out


def ebm_conditioning(inputs, got, want, n_perturb: int = 3):
    """The box model on the card (``got``) against the CPU (``want``) on
    seeded inputs that reach both branches of its cubic, where some points
    lie near a double root (the discriminant within rounding of zero):
    there the roots move by about the square root of a change of the
    coefficients, and a last-bit difference of the card's and the CPU's
    pow, arccos or cos moves them by up to about 1e-8. Each point is held
    to FORCING_BAND of the output's scale plus twice the CPU's own response
    to a random relative change of 4 ulps of every input (the largest over
    ``n_perturb`` changes): the card agrees with the CPU as closely as the
    CPU agrees with itself. Returns the plain error, the points beyond
    FORCING_BAND and whether every point is within its allowance."""
    eps = 4.0 * torch.finfo(torch.float64).eps
    gen = torch.Generator().manual_seed(SEED + 44)
    cpu = {k: torch.as_tensor(v) for k, v in inputs.items()}
    sens = [torch.zeros_like(w) for w in want]
    for _ in range(n_perturb):
        moved = {k: v * (1.0 + eps * (2.0 * torch.rand(
            v.shape, generator=gen, dtype=v.dtype) - 1.0))
            for k, v in cpu.items()}
        for s, m, w in zip(sens, estuary.ebm_solve(**moved, a1=0.876,
                                                   h0=0.5), want):
            torch.maximum(s, (m - w).abs(), out=s)
    out = {"rel_err": 0.0, "points_beyond_band": 0, "within_conditioning":
           True, "worst_err_over_allowance": 0.0}
    for g, w, s in zip(got, want, sens):
        err = (g.cpu() - w).abs()
        scale = float(w.abs().max()) or 1.0
        allow = FORCING_BAND * scale + 2.0 * s
        out["rel_err"] = max(out["rel_err"], float(err.max()) / scale)
        out["points_beyond_band"] += int((err > FORCING_BAND * scale).sum())
        out["worst_err_over_allowance"] = max(
            out["worst_err_over_allowance"], float((err / allow).max()))
        out["within_conditioning"] &= bool((err <= allow).all())
    return out


# the coupler cap: three steps an interval (prod_full's 24 steps a day), and
# each export field's physical range on the ocean points
CPL_INTERVAL = dict(coupling_freq_opt="nhour", coupling_freq=3)
EXPORT_RANGES = {"So_t": (271.0, 310.0), "So_s": (20.0, 42.0),
                 "So_u": (-3.0, 3.0), "So_v": (-3.0, 3.0),
                 "So_dhdx": (-1e-3, 1e-3), "So_dhdy": (-1e-3, 1e-3),
                 "So_ssh": (-5.0, 5.0), "Fioo_q": (-2000.0, 2000.0)}


def seeded_x2o(cfg, device, seed: int):
    """Seeded SI import fields (``coupled.IMPORT_FIELDS``) at the
    magnitudes of the JAX package's own cap test
    (tests/test_ocn_component.py), as tensors of the config's dtype on
    ``device``."""
    rng = np.random.RandomState(seed)
    shape = (cfg.ny, cfg.nx)

    def f(lo, hi=None):
        return rng.uniform(-lo, lo, shape) if hi is None \
            else rng.uniform(lo, hi, shape)
    fields = {"taux": f(0.1), "tauy": f(0.1), "swnet": f(0.0, 200.0),
              "sen": f(20.0), "lwup": f(50.0), "lwdn": f(50.0),
              "melth": f(5.0), "snow": f(1e-5), "rain": f(1e-5),
              "evap": f(1e-5), "melt": f(1e-6), "rofl": f(1e-6),
              "rofi": f(1e-7), "salt": f(1e-7), "ifrac": f(0.0, 0.3),
              "pslv": np.full(shape, 101325.0), "duu10n": f(0.0, 50.0)}
    assert set(fields) == set(coupled.IMPORT_FIELDS)
    return {k: torch.as_tensor(v).to(device=device, dtype=cfg.torch_dtype)
            for k, v in fields.items()}


def export_ranges(o2x, mask):
    """{field: [min, max]} of the export on the ocean points; the names of
    those outside EXPORT_RANGES or not finite."""
    ranges, bad = {}, []
    for name, t in o2x.items():
        v = t[mask]
        lo, hi = float(v.min()), float(v.max())
        ranges[name] = [lo, hi]
        want = EXPORT_RANGES[name]
        if not (bool(torch.isfinite(t).all()) and want[0] <= lo
                and hi <= want[1]):
            bad.append(name)
    return ranges, bad


def cpl_phase():
    """The coupler cap at full width: ``OcnComponent`` on prod_file's
    float32 configuration, three steps a coupling interval. ``initialize``,
    then two intervals under seeded import fields, the first ending in a
    restart written on request (``rstwr``); a second component resumed from
    that restart runs the second interval again, and its export must equal
    the first component's bitwise. Every export field finite and inside its
    physical range; the launches of each interval through the wrappers'
    counters (the first interval's those of three steps of prod_file from
    rest); the seconds an interval takes and the import and export in ms.
    Then the same first interval on the small file grid in float64, the
    GPU against the CPU, within small_vs_cpu_phase's band."""
    cfg = full_config("float32", "prod_file")
    x2o = seeded_x2o(cfg, DEV, SEED + 41)
    out = {"phase": "cpl", "path": "prod_file", "dtype": cfg.dtype,
           "dims": [cfg.nx, cfg.ny, cfg.km], "steps_per_interval": None}
    broken = []
    with tempfile.TemporaryDirectory(prefix="pop2_cpl_") as tmp:
        t0 = time.perf_counter()
        comp = OcnComponent(cfg, outdir=tmp, **CPL_INTERVAL)
        out["component_seconds"] = time.perf_counter() - t0
        mask = comp.model.grid.RCALCT > 0
        o2x0 = comp.initialize()
        exports, seconds, launches = [], [], []
        for rstwr in (True, False):
            n0 = comp.model.nsteps_total
            o2x, dt, counts, _ = _timed(lambda: comp.run(x2o, rstwr=rstwr))
            exports.append(o2x)
            seconds.append(dt)
            launches.append(counts)
            out["steps_per_interval"] = comp.model.nsteps_total - n0
        nsteps = out["steps_per_interval"]
        want = expected_counts("prod_file", nsteps, "float32")
        if launches[0] != want:
            broken.append(f"first interval's launches {launches[0]}, "
                          f"expected {want}")
        if not launches[1]["gm_chain"] or not launches[1]["tracer"]:
            broken.append("the second interval launched no kernel")
        out.update(interval_seconds=seconds, launches=launches,
                   restart_files=len(comp.restart_files))
        for name, o2x in (("initial", o2x0), ("interval_1", exports[0]),
                          ("interval_2", exports[1])):
            out[f"ranges_{name}"], bad = export_ranges(o2x, mask)
            broken += [f"{name} {b}" for b in bad]
        # the adapters' costs on the card: the import of an interval's
        # fields, and the export of the model state
        out["import_ms"] = time_ms(
            lambda: coupled.ocn_import(cfg, comp.model.grid, x2o), 2, 10)
        out["export_ms"] = time_ms(
            lambda: coupled.ocn_export(cfg, comp.model.grid, comp.state,
                                       comp.state.aqice), 2, 10)

        comp2 = OcnComponent(cfg, outdir=tmp, **CPL_INTERVAL)
        comp2.initialize(restart_dir=tmp)
        resumed = comp2.run(x2o)
        out["resumed_at_step"] = comp2.model.nsteps_total - nsteps
        out["resumed_bitwise"] = {n: bool(torch.equal(t, exports[1][n]))
                                  for n, t in resumed.items()}
        if not all(out["resumed_bitwise"].values()) or \
                set(resumed) != set(exports[1]):
            broken.append("the resumed interval's export differs")
        del comp, comp2
    gc.collect()
    torch.cuda.empty_cache()

    # the first interval on the small file grid, GPU against CPU, float64
    small = get_config("prod_full", **gx_files(*GX_SMALL))
    got = {}
    for key, dev in (("gpu", DEV), ("cpu", torch.device("cpu"))):
        with tempfile.TemporaryDirectory(prefix="pop2_cpl_") as tmp:
            comp = OcnComponent(small, outdir=tmp, device=dev,
                                **CPL_INTERVAL)
            comp.initialize()
            got[key] = comp.run(seeded_x2o(small, dev, SEED + 43))
    diffs = {n: _scale_err(got["gpu"][n], got["cpu"][n])
             for n in got["cpu"]}
    out["small_vs_cpu"] = {"dims": [small.nx, small.ny, small.km],
                           "dtype": small.dtype, "rel_diff": diffs,
                           "band": 1e-7}
    broken += [f"small {n} {d}" for n, d in diffs.items() if not d <= 1e-7]
    emit(out)
    if broken:
        raise AssertionError("cpl: " + "; ".join(broken))


SPAI_STEPS = 2


def spai_phase():
    """core's configuration in float64 with the 9-point SPAI preconditioner
    (``solvers.build_spai9``, built on the host at model construction) and
    with the same stencil written to an .npz and read back as the 'file'
    preconditioner, SPAI_STEPS steps each from the model's initial state:
    the two runs must agree bitwise. Prints the host build seconds, the
    iterations a step against the diagonal run (core's own), and
    ``pcg_lanczos_eigs``'s bounds of the leapfrog operator under the
    stencil (the JAX package measured the plain SPAI indefinite on gx1v7;
    at this grid both packages find a positive lower bound)."""
    base = full_config("float64", "core")
    spai = base.with_(solver=dataclasses.replace(base.solver,
                                                 preconditioner="spai"))
    out = {"phase": "spai", "path": "core", "dtype": base.dtype,
           "dims": [base.nx, base.ny, base.km], "steps": SPAI_STEPS}
    t0 = time.perf_counter()
    model = Model(spai)
    out["model_seconds"] = time.perf_counter() - t0
    op = solvers.make_operator(model.grid, diagonal_correction(
        spai, model.grid, True))
    t0 = time.perf_counter()
    stencil = solvers.build_spai9(spai, op)
    out["build_seconds"] = time.perf_counter() - t0
    for name in solvers.Precond9._fields:
        if not torch.equal(getattr(stencil, name),
                           getattr(model.precond, name)):
            raise AssertionError(f"spai: the model's stencil {name} is not "
                                 "the operator's")
    out["pcg_lanczos_eigs"] = solvers.pcg_lanczos_eigs(spai, op, model.bc,
                                                       stencil)
    states, iters = {}, {}
    with tempfile.TemporaryDirectory(prefix="pop2_precond_") as tmp:
        path = os.path.join(tmp, "precond.npz")
        np.savez(path, **{k: v.cpu().numpy()
                          for k, v in stencil._asdict().items()})
        file_cfg = spai.with_(solver=dataclasses.replace(
            spai.solver, preconditioner="file", preconditioner_file=path))
        for name, cfg in (("spai", spai), ("file", file_cfg),
                          ("diagonal", base)):
            m = model if name == "spai" else Model(cfg)
            state = m.initial_state()
            its = []
            for _ in range(SPAI_STEPS):
                state, diags = m.advance(state)
                its.append(int(diags.solver_iters))
            states[name], iters[name] = state, its
            del m
    equal = all(torch.equal(x, getattr(states["file"], n))
                for n, x in states["spai"].leaves())
    for name, st in states.items():
        for leaf, t in st.leaves():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"spai: {name} run's {leaf} not finite")
    out.update(solver_iters=iters, file_equals_spai_bitwise=equal)
    emit(out)
    if not equal:
        raise AssertionError("spai: the 'file' run differs from the 'spai' "
                             "run")
    if out["pcg_lanczos_eigs"][0] <= 0.0:
        raise AssertionError(f"spai: PCSI's lower bound under the stencil "
                             f"{out['pcg_lanczos_eigs']} is not positive")


# ---- the ocean decomposed over ranks ----------------------------------------
# prod_full at full size on the meshes of RANKS_MESHES, one process a block
# on the one card (gloo: NCCL refuses two ranks on one device; halos and
# reduction operands go through host buffers), with b4b sums, against the
# same run on the whole domain: y slabs of 192 rows, and 2-D blocks of
# 192 x 160 whose top row holds the tripole fold across two ranks
RANKS_MESHES = ((2, 1), (2, 2))
# float64, on every mesh: steps of Model.advance
RANKS_STEPS = 2
# float32, on (2, 2) (the y slabs' float32 run left out for the script's
# time limit): through Model.run_compiled, steps without a stream, then a
# tavg stream of every field prod_full evaluates, written once after as
# many steps again as its interval
RANKS_STREAM_STEPS = (2, 4)
# the decomposed fields against the whole domain's in the same dtype, of
# scale: float64 through advance (a fault in one dtype's halo or staging
# would show at any band above the rounding of the other); the float32 run
# through run_compiled with its stream bitwise
RANKS_BAND64 = 1e-12
# the small configurations held on (2, 2) blocks in the same ranks (their
# shape: 64 x 48 x 12; the overflows on the 'mini' grid their specs index)
RANKS_SMALL = dict(nx=64, ny=48, km=12, vert_grid="uniform")
RANKS_SMALL_STEPS = 2
# which wrapper counts a halo'd launch, and its kernel
RANKS_KERNELS = {"tracer_upwind3": (tracer_cuda, "tracer_tendency"),
                 "clinic": (clinic_cuda, "clinic_rhs_fields"),
                 "gm_slopes": (gm_slope_cuda, "slopes"),
                 "gm_chain_sm": (gm_chain_cuda, "chain"),
                 "gm_flux": (gm_cuda, "flux_assembly"),
                 "gm_flux_cancellation": (gm_cuda, "flux_assembly")}


def ranks_kernel_cases(dtype_name: str):
    """{name: (cfg, whole grid, arguments)} of the five stencil kernels at
    prod_full's shapes on the fold bottom with the top rows' faces opened:
    the tracer tendency (upwind3, five tracers), the momentum kernel
    without the Laplacian (the anisotropic path's), the slopes, the chain
    with the submesoscale fold-in, and the flux assembly in both branches on
    prod_flux's operands."""
    cfg = full_config(dtype_name, "prod_full")
    grid, bc, tr = fold_case(cfg)
    grid = sample.open_top_dxu(sample.open_top_face(grid))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
    f = random_fields(cfg, grid, gen)
    tmix = sample.grid_tracers(cfg, grid, SEED + 16)
    cases = {
        "tracer_upwind3": (cfg, grid, (
            f["ucur"], f["vcur"], tmix, f["told"], f["told"], f["vdc"],
            f["stf"], f["dh"])),
        "clinic": (cfg, grid, (
            f["ucur"], f["vcur"], f["uold"], f["vold"], f["uold"], f["vold"],
            1.02 + f["rho"][2], f["vvc"], f["smf"], f["dhu"], 0.6, 0.4)),
        "gm_slopes": (cfg, grid, (bc, tr, tmix))}
    slp, sla, n2 = gm_slope_cuda.slopes(cfg, grid, bc, tr, tmix)
    zt = grid.vgrid.zt
    hblt = ((zt[2] + (zt[8] - zt[2]) * (0.5 + 0.5 * torch.cos(
        2 * grid.TLAT))) * (grid.KMT > 0)).contiguous()
    tlt = gm_tlt_cuda.transition_layer(
        cfg, grid, gm.diabatic_depth(cfg, grid, bc, hblt), sla,
        gm._rossby_radius(grid))
    kv = gm.kappa_vertical_bfre(cfg, grid, tr, tmix, tlt.interior_depth,
                                n2=n2)
    sm = submeso.amplitudes(cfg, grid, bc, tr, tmix, 0.8 * hblt)
    cases["gm_chain_sm"] = (cfg, grid, (bc, tmix, slp, sla, kv, tlt, False,
                                        sm))
    cflux = full_config(dtype_name, "prod_flux")
    ops = list(sample.flux_operands(cflux, grid, bc, tr, tmix))
    cases["gm_flux"] = (cflux, grid, (bc, *ops, False))
    ops[5], ops[6] = torch.zeros_like(ops[5]), torch.zeros_like(ops[6])
    cases["gm_flux_cancellation"] = (cflux, grid, (bc, *ops, True))
    return cases


def _leaves(tree):
    out = []
    pmesh.tree_map(out.append, tree)
    return out


def ranks_kernel_checks(dtype_name: str, mesh):
    """Each stencil kernel launched halo'd on this rank's block against
    the whole-domain launch's rows and columns: bitwise, max abs
    difference, the launches of each (equal), the design the block's launch
    takes (``closed``: the closed instance on the extended block; ``fold``:
    the tripole instance on a top slab's whole rows; ``strip``: the tripole
    instance with the fold's rows read from the mirror strip, a top-row
    block of an x decomposition), and the halo'd call's ms (CUDA events
    around a call: its exchange and staging included) and exchanges (the
    grid's halo comes once, at a grid's first call)."""
    cases = ranks_kernel_cases(dtype_name)
    design = ("closed" if not mesh.fold
              else "strip" if mesh.px > 1 else "fold")
    slab_grid = {}
    out = {}
    for name, (cfg, grid, args) in cases.items():
        mod, fn_name = RANKS_KERNELS[name]
        fn = getattr(mod, fn_name)
        n0 = mod.launches
        want = fn(cfg, grid, *args)
        n_whole = mod.launches - n0
        if id(grid) not in slab_grid:
            slab_grid[id(grid)] = mesh.slab(grid)
        sgrid, sargs = slab_grid[id(grid)], mesh.slab(args)
        with pmesh.scope(mesh):
            n0, e0 = mod.launches, mesh.comm.exchanges
            got = fn(cfg, sgrid, *sargs)
            n_halo = mod.launches - n0
            ms = time_ms(lambda: fn(cfg, sgrid, *sargs), 1, 5)
            e0 = mesh.comm.exchanges
            fn(cfg, sgrid, *sargs)
            exchanges = mesh.comm.exchanges - e0
        bitwise, err = True, 0.0
        for g, w in zip(_leaves(got), _leaves(want)):
            if mesh.is_field(w):
                w = w[..., mesh.j0:mesh.j1, mesh.i0:mesh.i1]
            bitwise &= bool(torch.equal(g, w))
            err = max(err, float((g.double() - w.double()).abs().max()))
        out[name] = {"bitwise": bitwise, "max_abs_err": err,
                     "design": design, "launches_whole": n_whole,
                     "launches_halo": n_halo, "halo_ms": ms,
                     "exchanges_a_call": exchanges}
    return out


def ranks_worker(plan, shape):
    """One rank of ``ranks_phase`` (run by ``multihost.spawn_ranks``): each
    run of ``plan`` in turn on this rank's block of a ``shape`` mesh (the
    float64 ``advance`` run, ``ranks_run``; the float32 ``run_compiled``
    run with its stream, ``ranks_stream_run``; with ``small``, the small
    configurations, ``small_checks``), the card's memory released and its
    peak reset between them. Returns {run: its record}."""
    out = {}
    for name, fn, args in plan:
        torch.cuda.reset_peak_memory_stats()
        out[name] = fn(*args, shape)
        out[name]["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _parts():
    """(seconds of each part, ``part(name)`` closing the one since the
    last)."""
    part_s = {}
    t_part = [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now
    return part_s, part


def ranks_model(dtype_name: str, tracers_file: str, shape, dims=None):
    """(model, state, forcing) of prod_full with b4b (at ``dims``, by
    default 320 x 384 x 60) on this rank's block of a ``shape`` mesh (the
    whole domain for (1, 1); in a process of no process group every block,
    ``model.MeshModel``, whose state is the whole domain's) from the
    stratified tracers in ``tracers_file``, under the path's forcing."""
    cfg = full_config(dtype_name, "prod_full").with_(
        b4b=True, mesh_shape=tuple(shape), **(dims or {}))
    model = Model(cfg, device=DEV)
    mesh = model.mesh
    tracers = torch.load(tracers_file)
    if isinstance(mesh, pmesh.Decomposition):
        tracers = mesh.slab(tracers)
    tracers = tracers.to(DEV)
    rho = baroclinic._masked_density(model.step_cfg, model.grid,
                                     model.ts_range, tracers)
    state = model.initial_state().replace(
        tracer_cur=tracers, tracer_old=tracers, rho_cur=rho, rho_old=rho)
    return model, state, path_forcing(model)


def ranks_run(dtype_name: str, nsteps: int, tracers_file: str, shape):
    """prod_full with b4b on this rank's block of a ``shape`` mesh,
    ``nsteps`` of ``Model.advance`` from the stratified tracers in
    ``tracers_file`` under the path's forcing, each step timed; its launch
    counts and exchanges; the gathered fields (rank 0); then the kernels'
    halo'd launches (``ranks_kernel_checks``); the seconds of each part."""
    part_s, part = _parts()
    model, state, forcing = ranks_model(dtype_name, tracers_file, shape)
    mesh = model.mesh
    part("model")
    reset_counts()
    mesh.comm.reset_counts()
    iters, ms = [], []
    for _ in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diags = model.advance(state, forcing)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        iters.append(int(diags.solver_iters))
    counts, comm = read_counts(), mesh.comm.counts()
    part("steps")
    fields = {name: multihost.to_host_replicated(getattr(state, name), mesh)
              for name in PATH_FIELDS + ("tracer_cur",)}
    part("gather")
    del model, state, forcing
    gc.collect()
    torch.cuda.empty_cache()
    mesh.comm.reset_counts()
    reset_counts()
    kernels = ranks_kernel_checks(dtype_name, mesh)
    part("kernels")
    return {"rank": mesh.rank, "block": [mesh.j0, mesh.j1, mesh.i0,
                                         mesh.i1], "part_seconds": part_s,
            "fold": mesh.fold, "iters": iters, "step_ms": ms,
            "counts": counts, "comm": comm, "kernels": kernels,
            "fields": fields if mesh.rank == 0 else None}


def stream_steps(model, state, forcing, fields, outdir):
    """RANKS_STREAM_STEPS[0] steps of ``Model.run_compiled`` (one a call,
    each timed), a tavg stream of ``fields`` every RANKS_STREAM_STEPS[1]
    steps into ``outdir``, then that many steps more (the last writes).
    The same on the whole domain (captured from the stream's second step)
    and on a rank's block (uncaptured). Returns (state, record): the
    iterations and ms of every step, the launches of the whole run, the
    exchanges without and with the stream (a rank's), the write's seconds
    (a rank's part of the gather and, on rank 0, the file) and the files."""
    mesh = model.mesh
    comm = mesh.comm if mesh is not None else None
    iters, ms, counts = [], [], {}

    def steps(n):
        nonlocal state
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diags = model.run_compiled(state, 1, forcing)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            iters.append(int(diags.solver_iters))
    n0, n1 = RANKS_STREAM_STEPS
    reset_counts()
    if comm is not None:
        comm.reset_counts()
    steps(n0)
    if comm is not None:
        counts["without_stream"] = comm.counts()
        comm.reset_counts()
    os.makedirs(outdir, exist_ok=True)
    stream = model.enable_tavg(fields, freq_steps=n1, outdir=outdir)
    write, write_s = stream.write, []

    def timed_write(path, step_number=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = write(path, step_number)
        write_s.append(time.perf_counter() - t0)
        return out
    stream.write = timed_write
    steps(n1)
    if comm is not None:
        counts["with_stream"] = comm.counts()
    cap = model._captured
    rec = {
        "iters": iters, "step_ms": ms, "launches": read_counts(),
        "comm": counts, "write_seconds": write_s,
        "files": list(model.tavg_files),
        "accumulator_bytes": stream.buffer.numel()
        * stream.buffer.element_size(),
        "graphs": cap.graphs, "uncaptured": cap.uncaptured}
    if mesh is None:
        # the whole domain's captured step with the stream, as the
        # one-process mesh's is read (``local_stream_steps``)
        holder = [state]

        def more():
            holder[0], _ = model.run_compiled(holder[0], LOCAL_PROFILED,
                                              forcing)
        rec["device_split"] = _device_split(more, LOCAL_PROFILED)
    return state, rec


def ranks_stream_run(dtype_name: str, tracers_file: str, fields, outdir,
                     shape):
    """prod_full with b4b on this rank's block of a ``shape`` mesh through
    ``run_compiled`` with a tavg stream (``stream_steps``): the gathered
    fields (rank 0), then the kernels' halo'd launches."""
    part_s, part = _parts()
    model, state, forcing = ranks_model(dtype_name, tracers_file, shape)
    mesh = model.mesh
    part("model")
    state, rec = stream_steps(model, state, forcing, fields, outdir)
    part("steps")
    fields = {name: multihost.to_host_replicated(getattr(state, name), mesh)
              for name in PATH_FIELDS + ("tracer_cur",)}
    part("gather")
    del model, state, forcing
    gc.collect()
    torch.cuda.empty_cache()
    mesh.comm.reset_counts()
    reset_counts()
    kernels = ranks_kernel_checks(dtype_name, mesh)
    part("kernels")
    return {**rec, "rank": mesh.rank, "fold": mesh.fold,
            "block": [mesh.j0, mesh.j1, mesh.i0, mesh.i1],
            "part_seconds": part_s, "kernels": kernels,
            "fields": fields if mesh.rank == 0 else None}


def small_checks(outdir: str, shape):
    """The small configurations on this rank's block of a ``shape`` mesh
    (the whole domain for (1, 1)), float64 with b4b: prod_bgc's ecosystem
    at RANKS_SMALL, RANKS_SMALL_STEPS of ``advance``; the coupler cap on
    prod_full at RANKS_SMALL (an interval of CPL_INTERVAL's steps ending
    in a restart on request, a second cap on a (1, ranks) mesh resumed
    from it for a second interval); the 'mini' point-data overflow from
    dense source water, 5 steps. Returns each run's gathered fields (and
    the cap's exports) and seconds."""
    shape = tuple(shape)
    os.makedirs(outdir, exist_ok=True)
    mesh = None

    def gather(t):
        if mesh is None or mesh.comm is None:
            return t.detach().cpu()
        return torch.as_tensor(multihost.to_host_replicated(t, mesh))

    def fields_of(state):
        return {name: gather(getattr(state, name))
                for name in PATH_FIELDS + ("tracer_cur",)}
    out, part_s = {}, {}
    t0 = time.perf_counter()
    cfg = full_config("float64", "prod_bgc").with_(
        b4b=True, mesh_shape=shape, **RANKS_SMALL)
    model = Model(cfg, device=DEV)
    mesh = model.mesh
    forcing = path_forcing(model)
    state = model.initial_state()
    iters = []
    for _ in range(RANKS_SMALL_STEPS):
        state, diags = model.advance(state, forcing)
        iters.append(int(diags.solver_iters))
    out["ecosys"] = {"iters": iters, "fields": fields_of(state)}
    part_s["ecosys"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = full_config("float64", "prod_full").with_(
        b4b=True, mesh_shape=shape, **RANKS_SMALL)
    x2o = seeded_x2o(cfg, DEV, SEED + 45)
    first = OcnComponent(cfg, outdir=outdir, device=DEV, **CPL_INTERVAL)
    mesh = first.model.mesh
    exports = [first.gather_export(first.initialize()),
               first.gather_export(first.run(x2o, rstwr=True))]
    second = OcnComponent(cfg.with_(mesh_shape=(1, shape[0] * shape[1])),
                          outdir=outdir, device=DEV, **CPL_INTERVAL)
    second.initialize(restart_dir=outdir)
    exports.append(second.gather_export(second.run(x2o)))
    mesh = second.model.mesh
    out["cap"] = {"exports": [{k: torch.as_tensor(v) for k, v in e.items()}
                              for e in exports],
                  "resumed_at": second.model.nsteps_total,
                  "fields": fields_of(second.state)}
    part_s["cap"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = get_config("mini", dtype="float64", b4b=True, mesh_shape=shape,
                     overflows=(OVF_POINTS,))
    model = Model(cfg, device=DEV)
    mesh = model.mesh
    state = model.initial_state()
    src = torch.as_tensor(overflows.region_mask3(
        model.cfg, model.ovf_statics, 0, overflows.REG_SRC) > 0, device=DEV)
    if mesh is not None:
        src = mesh.slab(src)
    tracer = state.tracer_cur.clone()
    tracer[0] = torch.where(src, tracer[0] - 4.0, tracer[0])
    state = state.replace(tracer_cur=tracer, tracer_old=tracer)
    iters = []
    for _ in range(5):
        state, diags = model.advance(state)
        iters.append(int(diags.solver_iters))
    out["overflows"] = {"iters": iters, "fields": fields_of(state)}
    part_s["overflows"] = time.perf_counter() - t0
    out["part_seconds"] = part_s
    return out


KERNEL_COUNTERS = [k for k in COUNTERS if not k.endswith(("_fold", "_aniso"))]


def whole_runs(tmp, nsteps: int = RANKS_STEPS, dims=None):
    """The whole domain's runs the decomposed ones are held against,
    prod_full with b4b (at ``dims``, by default 320 x 384 x 60): ``nsteps``
    of ``Model.advance`` in float64, and in float32 ``Model.run_compiled``
    with a tavg stream of every field it evaluates (``stream_steps``);
    each from the stratified tracers it saves into ``tmp``. Returns
    ({dtype: record}, the stream's fields)."""
    wholes, stream_fields = {}, None
    for dtype_name in ("float64", "float32"):
        cfg = full_config(dtype_name, "prod_full").with_(b4b=True,
                                                         **(dims or {}))
        model = Model(cfg, device=DEV)
        state = stratified_state(model, SEED + 7)
        tracers_file = os.path.join(tmp, f"tracers_{dtype_name}.pt")
        torch.save(state.tracer_cur.cpu(), tracers_file)
        del model, state
        _MODELS.clear()
        _STRATIFIED.clear()
        model, state, forcing = ranks_model(dtype_name, tracers_file,
                                            (1, 1), dims)
        t0 = time.perf_counter()
        if dtype_name == "float64":
            reset_counts()
            iters, ms = [], []
            for _ in range(nsteps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, diags = model.advance(state, forcing)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t1))
                iters.append(int(diags.solver_iters))
            rec = {"iters": iters, "step_ms": ms,
                   "launches": read_counts()}
        else:
            stream_fields, raising = probe_fields(model, forcing)
            if raising:
                raise AssertionError(f"ranks: tavg fields raising "
                                     f"{sorted(raising)}")
            state, rec = stream_steps(
                model, state, forcing, stream_fields,
                os.path.join(tmp, "whole"))
            rec["stream_fields"] = len(stream_fields)
        rec.update(tracers_file=tracers_file,
                   seconds=time.perf_counter() - t0,
                   fields={name: getattr(state, name).cpu()
                           for name in PATH_FIELDS})
        wholes[dtype_name] = rec
        del model, state, forcing
        gc.collect()
        torch.cuda.empty_cache()
    return wholes, stream_fields


def ranks_phase(tmp, nsteps: int = RANKS_STEPS, meshes=RANKS_MESHES):
    """prod_full at 320 x 384 x 60 on each mesh of ``meshes`` (y slabs of
    192 rows; 2-D blocks of 192 x 160), one process a block on this card
    over gloo, b4b sums, against the same steps on the whole domain
    (``whole_runs``, into ``tmp``): ``nsteps`` of ``Model.advance`` in
    float64, and on (2, 2) in float32
    ``Model.run_compiled`` with a tavg stream of every field prod_full
    evaluates (``stream_steps``). Solver iterations identical every step,
    the fields within RANKS_BAND64 of scale of the whole-domain run in
    float64 and equal in float32, the stream's file equal to the whole
    domain's bytewise, every rank's launch counts those of the whole-domain
    run; each of the five stencil kernels launched halo'd on its block
    equal to the whole-domain launch's rows and columns bitwise, with the
    design it took. On (2, 2) the small configurations too
    (``small_checks``: the ecosystem, the coupler cap, the overflows),
    bitwise the whole domain's. Prints the step ms, exchanges, all-reduces
    and staged bytes a step with and without the stream, the write's
    seconds, peak memory a rank. Returns the whole domain's runs, the
    stream's fields and the (2, 2) records ({dtype: record}), which
    ``local_mesh_phase`` reads."""
    import chip_smoke as cs  # the ranks import this module by its name
    wholes, stream_fields = whole_runs(tmp, nsteps)
    t0 = time.perf_counter()
    small_whole = small_checks(os.path.join(tmp, "cpl_whole"), (1, 1))
    small_whole["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    ref = wholes["float64"]["fields"]
    gloo = {}
    for shape in meshes:
        tag = f"{shape[0]}x{shape[1]}"
        plan = [("float64", cs.ranks_run,
                 ("float64", nsteps, wholes["float64"]["tracers_file"]))]
        if shape == (2, 2):
            plan += [("float32", cs.ranks_stream_run,
                      ("float32", wholes["float32"]["tracers_file"],
                       stream_fields, os.path.join(tmp, tag))),
                     ("small", cs.small_checks,
                      (os.path.join(tmp, f"cpl_{tag}"),))]
        t0 = time.perf_counter()
        res = multihost.spawn_ranks(
            cs.ranks_worker, shape[0] * shape[1], backend="gloo",
            device="cuda", args=(plan, tuple(shape)), timeout=900)
        spawn_s = time.perf_counter() - t0
        for dtype_name, w in wholes.items():
            if dtype_name in res[0]:
                out = ranks_check(dtype_name, tuple(shape), w,
                                  [r[dtype_name] for r in res], ref,
                                  KERNEL_COUNTERS, spawn_s)
                if tuple(shape) == (2, 2):
                    gloo[dtype_name] = out
        if shape == (2, 2):
            small_check(small_whole, [r["small"] for r in res])
    return {"wholes": wholes, "stream_fields": stream_fields,
            "gloo": gloo}


# ---- the ocean on a one-process mesh -------------------------------------
# prod_full at full size on (2, 2) blocks in this process (the JAX
# package's mesh over one process's devices): a thread a block, every block
# on this card, the exchanges device copies (parallel.mesh.LocalComm), the
# captured step's graphs holding every block; held against the same whole
# domain runs as the ranks, bitwise
LOCAL_MESH = (2, 2)
# replays timed after the float32 run's last write (the stream still on),
# then one more under the profiler: its interval's write would come at the
# fourth step after that write
LOCAL_MORE = 2
LOCAL_PROFILED = 1


def block_count_reads(model):
    """Each block's launches, as ``read_counts`` reads the module's."""
    return [read_counts(c) for c in model.block_counts()]


def local_stream_steps(model, state, forcing, fields, outdir):
    """``stream_steps`` on a one-process mesh: RANKS_STREAM_STEPS[0]
    steps of ``run_compiled`` (one a call, each timed), a tavg stream of
    ``fields`` every RANKS_STREAM_STEPS[1] steps, that many steps more;
    the exchanges of an eager step without and with the stream (the replays
    run the same, in the graphs); the write's seconds; then LOCAL_MORE
    captured steps more with the stream (replays), timed and under the
    profiler (the device's busy share). Returns (state after the checked
    steps, record)."""
    mesh = model.mesh
    iters, ms, comm = [], [], {}

    def steps(n):
        nonlocal state
        for _ in range(n):
            mesh.reset_comm_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diags = model.run_compiled(state, 1, forcing)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            iters.append(int(diags.solver_iters))
            yield mesh.comm_counts()
    n0, n1 = RANKS_STREAM_STEPS
    for c in model.block_counts():
        c.reset()
    comm["without_stream"] = list(steps(n0))[-1]  # the eager leapfrog step
    os.makedirs(outdir, exist_ok=True)
    stream = model.enable_tavg(fields, freq_steps=n1, outdir=outdir)
    write, write_s = stream.write, []

    def timed_write(path, step_number=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = write(path, step_number)
        write_s.append(time.perf_counter() - t0)
        return out
    stream.write = timed_write
    comm["with_stream"] = list(steps(n1))[0]  # eager: the stream is new
    launches = block_count_reads(model)
    cap = model._captured
    checked, files, write_s = state, list(model.tavg_files), list(write_s)
    more_ms = []
    for _ in range(LOCAL_MORE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = model.run_compiled(state, 1, forcing)
        torch.cuda.synchronize()
        more_ms.append(1e3 * (time.perf_counter() - t0))
    holder = [state]

    def busy_steps():
        holder[0], _ = model.run_compiled(holder[0], LOCAL_PROFILED,
                                          forcing)
    split = _device_split(busy_steps, LOCAL_PROFILED) or {}
    return checked, {
        "iters": iters, "step_ms": ms, "launches": launches, "comm": comm,
        "write_seconds": write_s, "files": files,
        "accumulator_bytes": stream.buffer.numel()
        * stream.buffer.element_size(),
        "graphs": cap.graphs, "uncaptured": cap.uncaptured,
        "replays": cap.replays, "capture_seconds": cap.capture_seconds,
        "captured_step_ms": more_ms,
        "device_ms_a_step": split.get("kernel_ms"),
        "busy_share": split.get("busy_share"),
        "kernel_overlap": split.get("kernel_overlap"),
        "device_split": split or None}


def local_kernel_checks(dtype_name: str, mesh):
    """``ranks_kernel_checks`` on every block of a one-process mesh: each
    stencil kernel's halo'd launch on each block (all at once, a thread a
    block) against the whole-domain launch's rows and columns, bitwise;
    the launches of each (the block's own counters) and the exchanges of
    a call."""
    cases = ranks_kernel_cases(dtype_name)
    out = {}
    blocks = {}
    for name, (cfg, grid, args) in cases.items():
        mod, fn_name = RANKS_KERNELS[name]
        fn = getattr(mod, fn_name)
        n0 = mod.launches
        want = fn(cfg, grid, *args)
        n_whole = mod.launches - n0
        if id(grid) not in blocks:
            blocks[id(grid)] = mesh.cut(grid)
        sgrids, sargs = blocks[id(grid)], mesh.cut(args)

        def call(r):
            d, counts = mesh.blocks[r], mesh.driver.counts[r]
            n0, e0 = counts.get(mod), d.comm.exchanges
            got = fn(cfg, sgrids[r], *sargs[r])
            return got, counts.get(mod) - n0, d.comm.exchanges - e0
        res = mesh.run(call)
        recs = []
        for d, (got, n_halo, exchanges) in zip(mesh.blocks, res):
            bitwise, err = True, 0.0
            for g, w in zip(_leaves(got), _leaves(want)):
                if d.is_field(w):
                    w = w[..., d.j0:d.j1, d.i0:d.i1]
                bitwise &= bool(torch.equal(g, w))
                err = max(err, float((g.double() - w.double()).abs().max()))
            recs.append({"rank": d.rank, "bitwise": bitwise,
                         "max_abs_err": err,
                         "design": ("closed" if not d.fold else "strip"
                                    if d.px > 1 else "fold"),
                         "launches_whole": n_whole,
                         "launches_halo": n_halo,
                         "exchanges_a_call": exchanges})
        out[name] = recs
        del want, res
    return out


def local_run(dtype_name: str, whole, stream_fields, outdir, dims=None):
    """prod_full with b4b on a one-process (2, 2) mesh from ``whole``'s
    stratified tracers: in float64 RANKS_STEPS of ``Model.advance`` (each
    timed; the exchanges of each), in float32 ``local_stream_steps``; the
    fields, each block's launches, peak memory and the seconds of each
    part; at full size the kernels halo'd on every block
    (``local_kernel_checks``)."""
    part_s, part = _parts()
    torch.cuda.reset_peak_memory_stats()
    model, state, forcing = ranks_model(dtype_name, whole["tracers_file"],
                                        LOCAL_MESH, dims)
    mesh = model.mesh
    part("model")
    if dtype_name == "float64":
        for c in model.block_counts():
            c.reset()
        iters, ms, comm = [], [], []
        for _ in range(len(whole["iters"])):
            mesh.reset_comm_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diags = model.advance(state, forcing)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            iters.append(int(diags.solver_iters))
            comm.append(mesh.comm_counts())
        rec = {"iters": iters, "step_ms": ms,
               "launches": block_count_reads(model), "comm": comm}
    else:
        state, rec = local_stream_steps(model, state, forcing,
                                        stream_fields, outdir)
    rec["fields"] = {name: getattr(state, name).cpu()
                     for name in PATH_FIELDS}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    part("steps")
    del model, state, forcing, mesh
    gc.collect()
    torch.cuda.empty_cache()
    if dims is None:
        cfg = full_config(dtype_name, "prod_full")
        mesh = pmesh.make_mesh(LOCAL_MESH, cfg.ny, cfg.nx, tripole=True,
                               cyclic=True, devices=[DEV] * 4)
        rec["kernels"] = local_kernel_checks(dtype_name, mesh)
        del mesh
        gc.collect()
        torch.cuda.empty_cache()
        part("kernels")
    rec["part_seconds"] = part_s
    return rec


def local_mesh_phase(tmp, ranks=None, dims=None):
    """prod_full with b4b on a (2, 2) mesh in this process
    (``model.MeshModel``: a thread a block, every block on this card, the
    exchanges device copies), against the whole domain's runs of
    ``ranks_phase`` (``ranks``; or its own ``whole_runs`` at ``dims``):
    float64 through ``advance`` (fields 0.0, iterations and each block's
    launches equal), float32 through ``run_compiled`` with the tavg stream
    of every field (graphs > 0, fields 0.0, the file bytewise the whole
    domain's, iterations and each block's launches equal, nothing staged
    through the host), and at full size each stencil kernel halo'd on every
    block bitwise. Prints the captured step's ms and busy share, the
    exchanges and all-reduces a step, the write's seconds and peak memory
    beside the gloo ranks' figures of the same call."""
    if ranks is None:
        wholes, stream_fields = whole_runs(tmp, RANKS_STEPS, dims)
        ranks = {"wholes": wholes, "stream_fields": stream_fields,
                 "gloo": {}}
    wholes, ref = ranks["wholes"], ranks["wholes"]["float64"]["fields"]
    broken = {}
    for dtype_name in ("float64", "float32"):
        whole = wholes[dtype_name]
        t0 = time.perf_counter()
        rec = local_run(dtype_name, whole, ranks["stream_fields"],
                        os.path.join(tmp, f"local_{dtype_name}"), dims)
        seconds = time.perf_counter() - t0
        stream = dtype_name == "float32"
        bad = {}
        diffs = {}
        for name in PATH_FIELDS:
            g, w = rec["fields"][name], whole["fields"][name]
            if not bool(torch.isfinite(g).all()):
                bad[f"{name}_finite"] = False
            diffs[name] = float((g - w).abs().max())
            if diffs[name] != 0.0:
                bad[name] = diffs[name]
        if rec["iters"] != whole["iters"]:
            bad["iters"] = (rec["iters"], whole["iters"])
        for r, counts in enumerate(rec["launches"]):
            diff = {k: (counts[k], whole["launches"][k])
                    for k in KERNEL_COUNTERS
                    if counts[k] != whole["launches"][k]}
            if diff:
                bad[f"launches_block{r}"] = diff
        for name, recs in rec.get("kernels", {}).items():
            for k in recs:
                if not k["bitwise"] or k["launches_halo"] \
                        != k["launches_whole"]:
                    bad[f"{name}_block{k['rank']}"] = k
        comm = (rec["comm"] if not stream else
                [rec["comm"]["without_stream"], rec["comm"]["with_stream"]])
        staged = [c["staged_bytes"] for step in comm for c in step]
        if any(staged):
            bad["staged_bytes"] = staged
        out = {"phase": "local_mesh", "path": "prod_full",
               "dtype": dtype_name,
               "entry": "run_compiled" if stream else "advance",
               "backend": "local (one process, a thread a block)",
               "mesh": list(LOCAL_MESH), "b4b": True,
               "dims": dims or "320x384x60", "steps": len(rec["iters"]),
               "solver_iters": rec["iters"],
               "whole_step_ms": whole["step_ms"],
               "step_ms": rec["step_ms"], "max_abs_diff": diffs,
               "launches_whole": {k: whole["launches"][k]
                                  for k in KERNEL_COUNTERS},
               "launches_blocks_equal": not any(
                   k.startswith("launches_block") for k in bad),
               "peak_gb": rec["peak_gb"],
               "part_seconds": rec["part_seconds"], "seconds": seconds}
        if stream:
            files = rec["files"]
            same = (len(files) == len(whole["files"]) == 1
                    and _same_file(files[0], whole["files"][0]))
            if not same:
                bad["tavg_file"] = (files, whole["files"])
            if not rec["graphs"] or rec["uncaptured"] is not None:
                bad["captured"] = (rec["graphs"], rec["uncaptured"])
            out.update(
                graphs=rec["graphs"], replays=rec["replays"],
                capture_seconds=rec["capture_seconds"],
                tavg_file_bytes=os.path.getsize(whole["files"][0]),
                tavg_file_bitwise=same,
                write_seconds=rec["write_seconds"],
                write_seconds_whole=whole["write_seconds"],
                captured_step_ms=rec["captured_step_ms"],
                device_ms_a_step=rec["device_ms_a_step"],
                busy_share=rec["busy_share"],
                kernel_overlap=rec["kernel_overlap"],
                device_split=rec["device_split"],
                device_split_whole=whole.get("device_split"),
                per_step={part: {k: [c[k] for c in counts]
                                 for k in ("exchanges", "allreduces",
                                           "staged_bytes", "sent_bytes")}
                          for part, counts in rec["comm"].items()})
        else:
            out.update(
                exchanges_per_step=[[c["exchanges"] for c in step]
                                    for step in comm],
                allreduces_per_step=[[c["allreduces"] for c in step]
                                     for step in comm],
                staged_bytes_per_step=[[c["staged_bytes"] for c in step]
                                       for step in comm])
        if "kernels" in rec:
            out["kernels"] = rec["kernels"]
        gloo = ranks["gloo"].get(dtype_name)
        if gloo is not None:
            out["gloo_same_call"] = {
                k: gloo.get(k) for k in (
                    "step_ms_ranks", "whole_step_ms", "per_step",
                    "exchanges_per_step", "allreduces_per_step",
                    "staged_bytes_per_step", "write_seconds_ranks",
                    "peak_gb_ranks", "spawn_seconds") if k in gloo}
        emit(out)
        if bad:
            broken[dtype_name] = bad
    if broken:
        raise AssertionError(f"local mesh {LOCAL_MESH}: the one-process "
                             f"run differs: {broken}")


def _same_file(a, b, chunk=1 << 26) -> bool:
    """The two files' bytes equal, read a chunk at a time."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def ranks_check(dtype_name, shape, whole, res, ref, kernel_counters,
                spawn_s):
    """Holds one mesh's decomposed run in one dtype (``res``, a record a
    rank) against the whole domain's (``whole``) and prints it; raises
    where it differs."""
    iters, whole_counts = whole["iters"], whole["launches"]
    nsteps = len(iters)
    stream = dtype_name == "float32"
    got = {k: torch.as_tensor(v) for k, v in res[0]["fields"].items()
           if k in PATH_FIELDS}
    diffs = {}
    for name in PATH_FIELDS:
        if not bool(torch.isfinite(got[name]).all()):
            raise AssertionError(f"ranks {shape} {dtype_name}: {name} not "
                                 "finite")
        w = whole["fields"][name]
        diffs[name] = float((got[name] - w).abs().max()) / (
            float(w.abs().max()) or 1.0)
    band = dict.fromkeys(diffs, 0.0 if stream else RANKS_BAND64)
    # a reading only: the float32 run's distance from float64
    witness = None if dtype_name == "float64" else {
        name: float((whole["fields"][name].double() - ref[name]).abs()
                    .max()) / (float(ref[name].abs().max()) or 1.0)
        for name in PATH_FIELDS}
    broken = {k: v for k, v in diffs.items() if not v <= band[k]}
    for r in res:
        if r["iters"] != iters:
            broken[f"iters_rank{r['rank']}"] = (r["iters"], iters)
        key = "launches" if stream else "counts"
        bad = {k: (r[key][k], whole_counts[k])
               for k in kernel_counters
               if r[key][k] != whole_counts[k]}
        if bad:
            broken[f"launches_rank{r['rank']}"] = bad
        for name, k in r["kernels"].items():
            if not k["bitwise"] or (k["launches_halo"]
                                    != k["launches_whole"]):
                broken[f"{name}_rank{r['rank']}"] = k
    out = {"phase": "ranks", "path": "prod_full", "dtype": dtype_name,
           "entry": "run_compiled" if stream else "advance",
           "backend": "gloo", "mesh": list(shape), "ranks": len(res),
           "b4b": True, "blocks": [r["block"] for r in res],
           "fold_ranks": [r["rank"] for r in res if r["fold"]],
           "steps": nsteps, "solver_iters": iters,
           "solver_iters_ranks": [r["iters"] for r in res],
           "whole_step_ms": whole["step_ms"],
           "step_ms_ranks": [r["step_ms"] for r in res],
           "launches_whole": {k: whole_counts[k] for k in kernel_counters},
           "rel_diff": diffs, "band": band,
           "whole_float32_vs_float64": witness,
           "kernels": [{"rank": r["rank"], **r["kernels"]} for r in res],
           "peak_gb_ranks": [r["peak_gb"] for r in res],
           "part_seconds_ranks": [r["part_seconds"] for r in res],
           "spawn_seconds": spawn_s}
    if stream:
        n0, n1 = RANKS_STREAM_STEPS
        files = res[0]["files"]
        same = (len(files) == len(whole["files"]) == 1
                and _same_file(files[0], whole["files"][0]))
        if not same:
            broken["tavg_file"] = (files, whole["files"])
        if any(r["graphs"] != 0 or "gloo" not in r["uncaptured"]
               for r in res) or not whole["graphs"]:
            broken["captured"] = [(r["graphs"], r["uncaptured"])
                                  for r in res] + [whole["graphs"]]
        per_step = {
            part: {k: [r["comm"][part][k] / n for r in res]
                   for k in ("exchanges", "allreduces", "staged_bytes")}
            for part, n in (("without_stream", n0), ("with_stream", n1))}
        out.update(
            stream_fields=whole["stream_fields"],
            tavg_file_bytes=os.path.getsize(whole["files"][0]),
            tavg_file_bitwise=same,
            accumulator_bytes_ranks=[r["accumulator_bytes"] for r in res],
            graphs_whole=whole["graphs"],
            uncaptured_ranks=res[0]["uncaptured"],
            steps_without_and_with_stream=[n0, n1],
            per_step=per_step,
            write_seconds_whole=whole["write_seconds"],
            write_seconds_ranks=[r["write_seconds"] for r in res])
    else:
        comm = [r["comm"] for r in res]
        out.update(
            exchanges_per_step=[c["exchanges"] / nsteps for c in comm],
            allreduces_per_step=[c["allreduces"] / nsteps for c in comm],
            staged_bytes_per_step=[c["staged_bytes"] / nsteps
                                   for c in comm],
            sent_bytes_per_step=[c["sent_bytes"] / nsteps for c in comm])
    emit(out)
    if broken:
        raise AssertionError(f"ranks {shape} {dtype_name}: the decomposed "
                             f"run differs: {broken}")
    return out


def small_check(whole, res):
    """Holds the small configurations on (2, 2) blocks (``res``, a record
    a rank) against the whole domain's bitwise, and prints them."""
    broken, rel = {}, {}
    for name in ("ecosys", "cap", "overflows"):
        w, g = whole[name], res[0][name]
        for leaf in w["fields"]:
            d = float((g["fields"][leaf] - w["fields"][leaf]).abs().max())
            rel[f"{name}:{leaf}"] = d
            if d != 0.0:
                broken[f"{name}:{leaf}"] = d
        if "iters" in w and any(r[name]["iters"] != w["iters"]
                                for r in res):
            broken[f"{name}:iters"] = [r[name]["iters"] for r in res]
    for i, (g, w) in enumerate(zip(res[0]["cap"]["exports"],
                                   whole["cap"]["exports"])):
        for k in w:
            if not torch.equal(g[k], w[k]):
                broken[f"cap:export{i}:{k}"] = float(
                    (g[k] - w[k]).abs().max())
    if res[0]["cap"]["resumed_at"] != whole["cap"]["resumed_at"]:
        broken["cap:resumed_at"] = res[0]["cap"]["resumed_at"]
    emit({"phase": "ranks_small", "mesh": [2, 2], "dims": [
        RANKS_SMALL["nx"], RANKS_SMALL["ny"], RANKS_SMALL["km"]],
        "checks": ["ecosys (prod_bgc, nt = 39)",
                   "cap (prod_full, restart resumed on (1, 4))",
                   "overflows ('mini', point data)"],
        "max_abs_diff": rel, "exports": len(whole["cap"]["exports"]),
        "seconds_whole": whole["seconds"],
        "part_seconds_ranks": [r["part_seconds"] for r in res]})
    if broken:
        raise AssertionError(f"ranks small (2, 2): the decomposed runs "
                             f"differ: {broken}")


def ptxas_summary(log: str | None = None):
    """{kernel: {registers, spill-store bytes, static shared memory bytes,
    stack frame bytes}} at the worst instantiation of each kernel, from what
    nvcc printed when the library was built (``log``, by default this
    checkout's)."""
    keys = ("registers", "spill_store_bytes", "static_smem_bytes",
            "stack_frame_bytes")
    patterns = (r"Used (\d+) registers", r"(\d+) bytes spill stores",
                r"(\d+) bytes smem", r"(\d+) bytes stack frame")
    worst, entry = {}, None
    for line in (cb.build_log() if log is None else log).splitlines():
        m = re.search(r"entry function '\w*?(thomas|tracer_upw|tracer|clinic|"
                      r"gm_slope|gm_chain|gm_flux|gm_tlt)_kernel", line)
        if m:
            entry = worst.setdefault(m.group(1), dict.fromkeys(keys, 0))
        for key, pattern in zip(keys, patterns):
            m = re.search(pattern, line)
            if m and entry is not None:
                entry[key] = max(entry[key], int(m.group(1)))
    return worst


def main():
    if len(sys.argv) > 1:
        sys.exit("chip_smoke.py takes no arguments: it always runs every "
                 "phase")
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    lib = cb.lib()  # build (or reuse) and load the kernels
    # the planners' copies of what the library and the card say
    card_smem = lib.pop2_max_dynamic_smem()
    if card_smem != cb.SMEM_PER_BLOCK:
        raise AssertionError(f"the card gives a block {card_smem} bytes of "
                             f"shared memory, the planners assume "
                             f"{cb.SMEM_PER_BLOCK}")
    for nt, sm in itertools.product(range(1, gm_chain_cuda.MAX_TRACERS + 1),
                                    (False, True)):
        c_values = lib.pop2_gm_chain_smem_values(nt, int(sm))
        if c_values != gm_chain_cuda.smem_values(nt, sm):
            raise AssertionError(f"gm_chain shared memory a column (nt={nt}, "
                                 f"sm={sm}): library {c_values}, planner "
                                 f"{gm_chain_cuda.smem_values(nt, sm)}")
        gm_chain_cuda.launch_plan(8, nt, sm)  # fits 227 KB
    if lib.pop2_thomas_max_rhs() != tridiag_cuda.MAX_RHS:
        raise AssertionError(f"thomas right-hand sides a launch: library "
                             f"{lib.pop2_thomas_max_rhs()}, planner "
                             f"{tridiag_cuda.MAX_RHS}")
    if lib.pop2_gm_tlt_threads() != gm_tlt_cuda.THREADS:
        raise AssertionError(f"gm_tlt block: library "
                             f"{lib.pop2_gm_tlt_threads()} threads, planner "
                             f"{gm_tlt_cuda.THREADS}")
    if (lib.pop2_tracer_max_group(), lib.pop2_tracer_tile_rows()) != (
            tracer_cuda.MAX_GROUP, tracer_cuda.TILE_ROWS):
        raise AssertionError("tracer group cap and tile rows: library "
                             f"{lib.pop2_tracer_max_group()}, "
                             f"{lib.pop2_tracer_tile_rows()}, planner "
                             f"{tracer_cuda.MAX_GROUP}, "
                             f"{tracer_cuda.TILE_ROWS}")
    for ng, del2, upw3, pbc in itertools.product(
            range(1, tracer_cuda.MAX_GROUP + 1), (True, False),
            (False, True), (False, True)):
        c_values = lib.pop2_tracer_smem_values(ng, int(del2), int(upw3),
                                               int(pbc))
        want = tracer_cuda.smem_values(ng, del2, tracer_cuda.TILE_ROWS,
                                       upw3, pbc)
        if c_values != want:
            raise AssertionError(f"tracer shared memory (ng={ng}, del2="
                                 f"{del2}, upwind3={upw3}, pbc={pbc}): "
                                 f"library {c_values}, planner {want}")
        for vb in (4, 8):  # fits 227 KB
            tracer_cuda.launch_plan(vb, ng, del2, upw3, pbc)
    for (vb, rows), pbc in itertools.product(clinic_cuda.TILE_ROWS.items(),
                                             (False, True)):
        code = 0 if vb == 4 else 1
        c_rows = lib.pop2_clinic_tile_rows(code)
        c_values = lib.pop2_clinic_smem_values(code, int(pbc))
        want = clinic_cuda.smem_values(rows, pbc)
        if (c_rows, c_values) != (rows, want):
            raise AssertionError(f"clinic tile ({vb}-byte values, pbc="
                                 f"{pbc}): library {c_rows} rows, "
                                 f"{c_values} values, planner {rows}, "
                                 f"{want}")
    c_rows, c_values = (lib.pop2_gm_slope_tile_rows(),
                        lib.pop2_gm_slope_smem_values())
    want = gm_slope_cuda.smem_values(gm_slope_cuda.TILE_ROWS)
    if (c_rows, c_values) != (gm_slope_cuda.TILE_ROWS, want):
        raise AssertionError(f"gm_slope tile: library {c_rows} rows, "
                             f"{c_values} values, planner "
                             f"{gm_slope_cuda.TILE_ROWS}, {want}")
    if lib.pop2_gm_flux_max_tracers() != gm_cuda.MAX_TRACERS:
        raise AssertionError(f"gm_flux tracer cap: library "
                             f"{lib.pop2_gm_flux_max_tracers()}, planner "
                             f"{gm_cuda.MAX_TRACERS}")
    for nt, cancel, aniso in itertools.product(
            range(1, gm_cuda.MAX_TRACERS + 1), (True, False), (False, True)):
        c_plan = (lib.pop2_gm_flux_tile_rows(nt),
                  lib.pop2_gm_flux_smem_values(nt, int(cancel), int(aniso)))
        want = (gm_cuda.tile_rows(nt),
                gm_cuda.smem_values(nt, cancel, aniso))
        if c_plan != want:
            raise AssertionError(f"gm_flux tile (nt={nt}, cancellation="
                                 f"{cancel}, aniso={aniso}): library rows, "
                                 f"values {c_plan}, planner {want}")
        for vb in (4, 8):  # fits 227 KB
            gm_cuda.launch_plan(vb, nt, cancel, aniso)
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": cb.build_seconds,
          "library": "nvcc sm_90a, ctypes",
          "smem_per_block_bytes": card_smem,
          "ptxas_worst_instance": ptxas_summary()})

    by_phase = collections.Counter()  # seconds of each phase function

    def run(phase, *args):
        t0 = time.perf_counter()
        try:
            return phase(*args)
        finally:
            by_phase[phase.__name__] += time.perf_counter() - t0
            if phase in (run_loop_phase, tavg_phase):
                # the phase's model and captured step (they refer to each
                # other) and their graphs' pools go back to the card:
                # prod_bgc's float64 graphs alone hold 38 GB
                gc.collect()
                torch.cuda.empty_cache()

    records = {}
    for dtype_name in ("float32", "float64"):
        records[dtype_name] = run(kernel_phase, dtype_name)
        records[dtype_name].update(run(gm_kernel_phase, dtype_name))
        records[dtype_name].update(run(fold_kernel_phase, dtype_name))
        records[dtype_name].update(run(mix_kernel_phase, dtype_name))
        records[dtype_name].update(run(flux_fold_phase, dtype_name))
        records[dtype_name].update(run(pbc_kernel_phase, dtype_name))
        records[dtype_name].update(run(bgc_kernel_phase, dtype_name))
        run(other_modes_phase, dtype_name)
        run(gm_other_modes_phase, dtype_name)
        run(ragged_phase, dtype_name)
        run(fold_ragged_phase, dtype_name)
        run(menu_parts_phase, dtype_name)
    launches = {}
    for path in PATHS:
        for dtype_name in STEPS[path]:
            launches[(path, dtype_name)] = run(path_phase, path, dtype_name)
        # with the path's models still built, over one step (the script's
        # time limit)
        if path not in ("gm_flux", "prod_flux"):
            run(path_vs_plain_phase, path, 1)
    _MODELS.clear()
    captured = {}
    for path, dtype_name, nsteps in RUN_LOOP:
        captured[(path, dtype_name)] = run(run_loop_phase, path, dtype_name,
                                           nsteps)
    for path, dtype_name, nsteps in TAVG:
        rec = run(tavg_phase, path, dtype_name, nsteps,
                  captured[(path, dtype_name)])
        launches[(path + "_tavg", dtype_name)] = rec["launches"]
        captured[(path + "_tavg", dtype_name)] = rec
    # where a step's time goes: the production configuration from a
    # stratified state (the breakdown from rest and the other paths', kept
    # in PERF.md, left out for the script's time limit)
    run(breakdown_phase, "prod_full", "float32", True)
    # the earlier paths over two steps (an Euler and a leapfrog step), the
    # newest over five (the script's time limit)
    for path in ("core", "gm_full", "prod_dyn", "prod_mix", "prod_full",
                 "prod_vmix", "prod_hmix", "core_topo", "prod_eg",
                 "prod_aniso", "core_lw", "prod_pbc", "prod_forced",
                 "prod_bgc", "prod_flux"):
        run(small_vs_cpu_phase, path, 2)
    run(small_vs_cpu_phase, "prod_file")
    run(forcing_phase, captured[("prod_forced", "float32")])
    run(cpl_phase)
    run(spai_phase)
    run(bgc_phase)
    run(overflow_phase)
    with tempfile.TemporaryDirectory(prefix="pop2_ranks_in_") as tmp:
        ranks = run(ranks_phase, tmp)
        run(local_mesh_phase, tmp, ranks)

    kernels = []
    for dtype_name, recs in records.items():
        for name, r in recs.items():
            source, replaces = SOURCES[name]
            counter = COUNTER_OF.get(name, name)
            n = launches[(PATH_OF[name], dtype_name)][counter]
            if not n:
                raise AssertionError(
                    f"{name} ({dtype_name}) was not launched on the "
                    f"{PATH_OF[name]} path")
            run = captured.get((PATH_OF[name], dtype_name))
            kernels.append({"name": f"{name}_{dtype_name}", "route": "cuda",
                            "source": source, "replaces": replaces,
                            "path": PATH_OF[name], "launches": n,
                            "launches_run_compiled": (
                                run["launches"][counter] if run else None),
                            "launches_prod_forced": launches[
                                ("prod_forced", dtype_name)][counter],
                            "launches_prod_file": launches[
                                ("prod_file", dtype_name)][counter],
                            **r, "library_ms": None})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "seconds_by_phase": dict(by_phase)})
    print(smi, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
