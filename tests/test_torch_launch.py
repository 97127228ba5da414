"""The launch planners of the kernels that stage in shared memory
(thomas, GM slopes, GM chain, GM flux assembly, tracer tendency, momentum
forcing): plain Python that chooses the block shape and the dynamic shared
memory for each (value size, right-hand sides or tracers, levels, mode),
and refuses what the kernels do not take,
before anything is built; the plan and the refusals of the
transition-layer search (a thread a column, no shared memory); and the grid
statics the tracer and momentum kernels read. Runs on the CPU; the kernels themselves are held against their
plain versions on the card by chip_smoke.py, which also holds the planners'
shared-memory counts against the library's."""

import itertools

import pytest
import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import advect, clinic_cuda, gm_chain_cuda, gm_cuda
from pop2_tpu_torch import gm_slope_cuda, gm_tlt_cuda, tracer_cuda
from pop2_tpu_torch import tridiag_cuda, vmix
from pop2_tpu_torch.config import get_config
from pop2_tpu_torch.grid import build_grid


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, to reach a wrapper's
    kernel branch without one."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError("the wrapper built the kernels before refusing")
    monkeypatch.setattr(cb, "lib", refuse)


# the smallest and the largest slab the kernel takes
@pytest.mark.parametrize("value_bytes,nr,km", [(4, 1, 1), (8, 4, 64)])
def test_thomas_plan_stages_the_slab_with_two_blocks_an_sm(value_bytes, nr,
                                                           km):
    cols, smem = tridiag_cuda.launch_plan(value_bytes, nr, km)
    assert cols == 32
    assert smem == (1 + nr) * km * cols * value_bytes
    # at least two blocks fit an SM's 228 KB, 1 KB of it kept a block
    assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("args,match", [
    ((4, 1, 65), "64 levels"),
    ((4, 1, 0), "64 levels"),
    ((8, 5, 60), "1 to 4; rhs_groups"),
    ((8, 0, 60), "1 to 4; rhs_groups"),
])
def test_thomas_plan_refuses(args, match):
    with pytest.raises(NotImplementedError, match=match):
        tridiag_cuda.launch_plan(*args)


# every count up to four launches' worth: groups of at most MAX_RHS that
# cover the right-hand sides once, in order, as even as the count allows,
# each within the plan's bounds at the production depth in float64
@pytest.mark.parametrize("nr", range(1, 17))
def test_thomas_groups_cover_every_rhs_once(nr):
    groups = tridiag_cuda.rhs_groups(nr)
    assert len(groups) == -(-nr // tridiag_cuda.MAX_RHS)
    assert [n0 for n0, _ in groups] == [sum(n for _, n in groups[:g])
                                        for g in range(len(groups))]
    sizes = [n for _, n in groups]
    assert sum(sizes) == nr and max(sizes) - min(sizes) <= 1
    assert max(sizes) <= tridiag_cuda.MAX_RHS
    for n in sizes:
        cols, smem = tridiag_cuda.launch_plan(8, n, 60)
        assert 2 * (smem + 1024) <= 228 * 1024


def test_thomas_groups_refuse_no_rhs():
    with pytest.raises(ValueError, match="0 right-hand sides"):
        tridiag_cuda.rhs_groups(0)


# the smallest tile, and the largest the kernel takes (16 tracers in float64)
@pytest.mark.parametrize("value_bytes,nt,rows", [(4, 1, 8), (8, 16, 6)])
def test_chain_plan_fits_the_tile(value_bytes, nt, rows):
    (cols, got_rows), smem = gm_chain_cuda.launch_plan(value_bytes, nt)
    assert (cols, got_rows) == (gm_chain_cuda.TILE_COLS, rows)
    assert smem == gm_chain_cuda.smem_values(nt) * cols * rows * value_bytes
    assert smem <= cb.SMEM_PER_BLOCK


# with the submesoscale fold-in: five more values a column, and still the
# largest tile (16 tracers in float64) within 227 KB
@pytest.mark.parametrize("value_bytes", [4, 8])
@pytest.mark.parametrize("nt", [1, 2, 16])
def test_chain_plan_with_sm_fits_the_tile(value_bytes, nt):
    (cols, rows), smem = gm_chain_cuda.launch_plan(value_bytes, nt, sm=True)
    assert (cols, rows) == gm_chain_cuda.launch_plan(value_bytes, nt)[0]
    assert gm_chain_cuda.smem_values(nt, True) == (
        gm_chain_cuda.smem_values(nt) + gm_chain_cuda.SM_PLANES)
    assert smem == gm_chain_cuda.smem_values(nt, True) * cols * rows * \
        value_bytes
    assert smem <= cb.SMEM_PER_BLOCK


def test_chain_flags_select_the_sm_instance():
    cfg = get_config("mini", hmix_tracer="gm", gm_transition_layer=True,
                     gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre")
    assert gm_chain_cuda.kernel_flags(cfg, False) == 0b0101
    assert gm_chain_cuda.kernel_flags(cfg, False, sm=True) == 0b1101
    assert gm_chain_cuda.kernel_flags(cfg, True, sm=True) == 0b1111


@pytest.mark.parametrize("args,err,match", [
    ((4, 17), NotImplementedError, "16 tracers"),
    ((8, 0), NotImplementedError, "16 tracers"),
    ((2, 2), TypeError, "float32 or float64"),
])
def test_chain_plan_refuses(args, err, match):
    with pytest.raises(err, match=match):
        gm_chain_cuda.launch_plan(*args)


def test_check_smem_refuses_a_block_over_227_kb():
    cb.check_smem(cb.SMEM_PER_BLOCK, "a block at the limit")
    with pytest.raises(ValueError, match="227 KB"):
        cb.check_smem(cb.SMEM_PER_BLOCK + 1, "a block over it")


@pytest.mark.parametrize("nr,km,match", [(1, 65, "64 levels"),
                                         (6, 65, "64 levels")])
def test_thomas_wrapper_refuses_before_building(no_build, nr, km, match):
    ny, nx = 3, 4
    rhs = torch.zeros(nr, km, ny, nx).as_subclass(OnCard)
    with pytest.raises(NotImplementedError, match=match):
        tridiag_cuda.thomas(torch.ones(km), torch.ones(ny, nx),
                            torch.full((ny, nx), km, dtype=torch.int32),
                            torch.zeros(km, ny, nx), rhs)


def test_chain_wrapper_refuses_before_building(no_build, monkeypatch):
    """17 tracers are two launches (9 + 8, ``gm_chain_cuda.tracer_groups``);
    each group's tile is planned, and a tile the card cannot hold refused,
    before anything is built."""
    cfg = get_config("mini", hmix_tracer="gm", gm_transition_layer=True,
                     gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
                     lsubmeso=False)
    grid = build_grid(cfg, "cpu")
    f3 = (cfg.km, cfg.ny, cfg.nx)
    assert gm_chain_cuda.tracer_groups(17, 4) == [(0, 9), (9, 8)]
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", 16 * 1024)
    tmix = torch.zeros((17,) + f3).as_subclass(OnCard)
    with pytest.raises(ValueError, match="nt=9"):
        gm_chain_cuda.chain(cfg, grid, None, tmix, None, None, None, None)


# every (dtype, tracers a launch, mode) the tracer kernel is instantiated for
@pytest.mark.parametrize("value_bytes", [4, 8])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("del2", [True, False])
def test_tracer_plan_fits_the_tile(value_bytes, ng, del2):
    (cols, rows), smem = tracer_cuda.launch_plan(value_bytes, ng, del2)
    assert (cols, rows) == (tracer_cuda.TILE_COLS, tracer_cuda.TILE_ROWS)
    assert smem == tracer_cuda.smem_values(ng, del2, rows) * value_bytes
    assert smem <= cb.SMEM_PER_BLOCK


# the modes the column form once ran (upwind3, and centered advection on a
# tripole edge) run the staged tile: upwind3 in its frame of two columns,
# the tripole edge in the layout of its north edge's mode
@pytest.mark.parametrize("value_bytes", [4, 8])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("del2", [True, False])
def test_tracer_column_plan(value_bytes, ng, del2):
    for upwind3 in (True, False):
        (cols, rows), smem = tracer_cuda.launch_plan(value_bytes, ng, del2,
                                                     upwind3)
        assert (cols, rows) == (tracer_cuda.TILE_COLS, tracer_cuda.TILE_ROWS)
        assert smem == tracer_cuda.smem_values(ng, del2, rows,
                                               upwind3) * value_bytes
        assert 0 < smem <= cb.SMEM_PER_BLOCK
    # the frame of two columns holds more than the one of one
    assert (tracer_cuda.smem_values(ng, del2, tracer_cuda.TILE_ROWS, True)
            > tracer_cuda.smem_values(ng, del2, tracer_cuda.TILE_ROWS))


# the upwind3 layout of prod_dyn's launch (two tracers, no Laplacian),
# counted by hand: once a tile 2 x 297 + 432 + 7 x 40 + 12 x 256, then two
# buffers each of a frame level (2 x 297 + 2 x 432), a centre level (3 x 2
# x 256) and the published fluxes (6 x 297); float32 leaves four blocks an
# SM and float64 two (228 KB, 1 KB a block)
def test_tracer_upwind3_layout_by_hand():
    values = tracer_cuda.smem_values(2, False, tracer_cuda.TILE_ROWS, True)
    assert values == (2 * 297 + 432 + 7 * 40 + 12 * 256
                      + 2 * (2 * 297 + 2 * 432 + 3 * 2 * 256 + 6 * 297))
    assert values == 13930
    assert 4 * (4 * values + 1024) <= 228 * 1024
    assert 2 * (8 * values + 1024) <= 228 * 1024


# partial bottom cells: centered advection two more frame planes (KMU and
# DZBU, 2 x 340), upwind3 DZBU on the face region and KMU there as bytes
# (297 + 75 values); the float32 upwind3 tile of two tracers keeps its four
# blocks an SM and the float64 one its two
def test_tracer_pbc_layout_by_hand():
    rows = tracer_cuda.TILE_ROWS
    for ng, del2 in ((1, True), (2, False), (2, True)):
        assert (tracer_cuda.smem_values(ng, del2, rows, False, True)
                == tracer_cuda.smem_values(ng, del2, rows) + 2 * 340)
        assert (tracer_cuda.smem_values(ng, del2, rows, True, True)
                == tracer_cuda.smem_values(ng, del2, rows, True) + 297 + 75)
    values = tracer_cuda.smem_values(2, False, rows, True, True)
    assert values == 14302
    assert 4 * (4 * values + 1024) <= 228 * 1024
    assert 2 * (8 * values + 1024) <= 228 * 1024
    for value_bytes, upwind3 in itertools.product((4, 8), (False, True)):
        smem = tracer_cuda.launch_plan(value_bytes, 2, True, upwind3,
                                       True)[1]
        assert smem == tracer_cuda.smem_values(2, True, rows, upwind3,
                                               True) * value_bytes


@pytest.mark.parametrize("value_bytes", [4, 8])
@pytest.mark.parametrize("upwind3", [True, False])
def test_tracer_plan_refuses_an_over_size_tile(monkeypatch, value_bytes,
                                               upwind3):
    need = tracer_cuda.smem_values(2, True, tracer_cuda.TILE_ROWS,
                                   upwind3) * value_bytes
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", need - 1)
    with pytest.raises(ValueError, match="shared memory a block"):
        tracer_cuda.launch_plan(value_bytes, 2, True, upwind3)
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", need)
    assert tracer_cuda.launch_plan(value_bytes, 2, True, upwind3)[1] == need


@pytest.mark.parametrize("over,column", [
    (dict(), False), (dict(tadvect="upwind3"), True),
    (dict(ns_boundary="tripole"), True),
    (dict(tadvect="upwind3", ns_boundary="tripole"), True)])
def test_tracer_column_mode_follows_advection_and_north_edge(over, column):
    # (upwind3, fold): the instance; both off is the core path's
    mode = tracer_cuda.tile_mode(get_config("mini", **over))
    assert mode == (over.get("tadvect") == "upwind3",
                    over.get("ns_boundary") == "tripole")
    assert any(mode) == column


def test_upwind3_operands_are_grid_statics():
    cfg = get_config("mini", tadvect="upwind3", ns_boundary="tripole")
    grid = build_grid(cfg, "cpu")
    upw, lev = tracer_cuda.upwind3_operands(cfg, grid, torch.float64,
                                            grid.KMT.device)
    assert upw.shape == (12, cfg.ny, cfg.nx) and lev.shape == (cfg.km, 11)
    assert upw.is_contiguous() and lev.is_contiguous()
    # the level table's rows: dz, dzr, dz2r, dzwr2, talfzp .. tdelzm and
    # 1/dz rounded once
    vg = grid.vgrid
    for col, want in enumerate((vg.dz, vg.dzr, vg.dz2r, vmix.dzwr2(grid),
                                *advect.upwind3_vert_coeffs(vg.dz),
                                1.0 / vg.dz)):
        assert torch.equal(lev[:, col], want)
    assert tracer_cuda.upwind3_operands(cfg, grid, torch.float64,
                                        grid.KMT.device)[0] is upw
    assert bool(torch.isfinite(upw).all()) and bool(torch.isfinite(lev).all())


@pytest.mark.parametrize("value_bytes", [4, 8])
def test_clinic_plan_fits_the_tile(value_bytes):
    (cols, rows), smem = clinic_cuda.launch_plan(value_bytes)
    assert (cols, rows) == (clinic_cuda.TILE_COLS,
                            clinic_cuda.TILE_ROWS[value_bytes])
    assert smem == clinic_cuda.smem_values(rows) * value_bytes
    assert smem <= cb.SMEM_PER_BLOCK


# partial bottom cells: KMU and DZBU as two more frame planes; three
# blocks an SM in float32, two in float64, as on full cells
@pytest.mark.parametrize("value_bytes", [4, 8])
def test_clinic_pbc_plan_fits_the_tile(value_bytes):
    (cols, rows), smem = clinic_cuda.launch_plan(value_bytes, True)
    plane = (clinic_cuda.TILE_COLS + 2) * (rows + 2)
    assert smem == (clinic_cuda.smem_values(rows) + 2 * plane) * value_bytes
    blocks = 3 if value_bytes == 4 else 2
    assert blocks * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("args,err,match", [
    ((4, 3, True), NotImplementedError, "at most 2 tracers"),
    ((8, 0, False), NotImplementedError, "at most 2 tracers"),
    ((2, 1, True), TypeError, "float32 or float64"),
])
def test_tracer_plan_refuses(args, err, match):
    with pytest.raises(err, match=match):
        tracer_cuda.launch_plan(*args)


def test_clinic_plan_refuses_other_values():
    with pytest.raises(TypeError, match="float32 or float64"):
        clinic_cuda.launch_plan(2)


@pytest.mark.parametrize("nt", [1, 2, 3, 4, 5, 16])
def test_tracer_groups_cover_every_tracer_once(nt):
    groups = tracer_cuda.tracer_groups(nt)
    covered = [n0 + n for n0, ng in groups for n in range(ng)]
    assert covered == list(range(nt))
    assert all(1 <= ng <= tracer_cuda.MAX_GROUP for _, ng in groups)
    # within the cap one launch, so the path's launch counts stay one a step
    assert len(groups) == -(-nt // tracer_cuda.MAX_GROUP)


def _mini_fields(cfg, nt):
    f3 = (cfg.km, cfg.ny, cfg.nx)
    zeros = torch.zeros
    return dict(u=zeros(f3), v=zeros(f3), trcr=zeros((nt,) + f3),
                vdc=zeros((2,) + f3), stf=zeros(nt, cfg.ny, cfg.nx),
                dh=zeros(cfg.ny, cfg.nx))


@pytest.mark.parametrize("hmix", ["del2", "gm"])
def test_tracer_wrapper_refuses_a_tile_over_the_card(no_build, monkeypatch,
                                                     hmix):
    extra = {} if hmix == "del2" else dict(
        hmix_tracer="gm", gm_transition_layer=True,
        gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre", lsubmeso=False)
    cfg = get_config("mini", **extra)
    grid = build_grid(cfg, "cpu")
    f = _mini_fields(cfg, 3)
    trcr = f["trcr"].as_subclass(OnCard)
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", 16 * 1024)
    with pytest.raises(ValueError, match="shared memory a block"):
        tracer_cuda.tracer_tendency(cfg, grid, f["u"], f["v"], trcr,
                                    f["trcr"], f["trcr"], f["vdc"], f["stf"],
                                    f["dh"])


def test_clinic_wrapper_refuses_a_tile_over_the_card(no_build, monkeypatch):
    cfg = get_config("mini")
    grid = build_grid(cfg, "cpu")
    f3 = (cfg.km, cfg.ny, cfg.nx)
    u = torch.zeros(f3)
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", 16 * 1024)
    with pytest.raises(ValueError, match="shared memory a block"):
        clinic_cuda.clinic_rhs_fields(
            cfg, grid, u.as_subclass(OnCard), u, u, u, u, u, u, u,
            torch.zeros(2, cfg.ny, cfg.nx), torch.zeros(cfg.ny, cfg.nx),
            1.0, 0.0)


def test_dzwr2_is_a_grid_static_of_the_mid_level_spacing():
    cfg = get_config("mini")
    grid = build_grid(cfg, "cpu")
    dz = grid.vgrid.dz.double().numpy()
    got = vmix.dzwr2(grid)
    below = list(dz[1:]) + [dz[-1]]  # the bottom level's own thickness
    want = [1.0 / (0.5 * (a + b)) for a, b in zip(dz, below)]
    assert got.shape == (cfg.km,) and got.dtype == grid.vgrid.dz.dtype
    assert torch.allclose(got.double(), torch.tensor(want), rtol=1e-15,
                          atol=0.0)
    # built once: the tracer and momentum kernels read the same tensor
    assert vmix.dzwr2(grid) is got
    assert clinic_cuda.kernel_statics(cfg, grid)[1] is got


@pytest.mark.parametrize("value_bytes", [4, 8])
def test_slope_plan_fits_the_tile(value_bytes):
    (cols, rows), smem = gm_slope_cuda.launch_plan(value_bytes)
    assert (cols, rows) == (gm_slope_cuda.TILE_COLS, gm_slope_cuda.TILE_ROWS)
    assert smem == gm_slope_cuda.smem_values(rows) * value_bytes
    # a ring of four levels of T and S: small enough that registers, not
    # shared memory, set the blocks an SM (eight blocks fit)
    assert 8 * (smem + 1024) <= 228 * 1024


def test_slope_plan_refuses_other_values():
    with pytest.raises(TypeError, match="float32 or float64"):
        gm_slope_cuda.launch_plan(2)


def test_slope_plan_refuses_a_tile_over_the_card(monkeypatch):
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", 8 * 1024)
    with pytest.raises(ValueError, match="227 KB"):
        gm_slope_cuda.launch_plan(8)


# the path's tracers, one, and the cap, in both branches and dtypes
@pytest.mark.parametrize("value_bytes", [4, 8])
@pytest.mark.parametrize("nt", [1, 2, 16])
@pytest.mark.parametrize("cancellation", [True, False])
def test_flux_plan_fits_the_tile(value_bytes, nt, cancellation):
    (cols, rows), smem = gm_cuda.launch_plan(value_bytes, nt, cancellation)
    assert cols == gm_cuda.TILE_COLS
    # the model's two tracers on the wide tile, any other count narrow
    assert rows == (gm_cuda.TILE_ROWS if nt == 2 else gm_cuda.NARROW_ROWS)
    assert smem == gm_cuda.smem_values(nt, cancellation) * value_bytes
    assert smem <= cb.SMEM_PER_BLOCK
    if nt == 2:  # the model's path: two blocks an SM at least
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("args,err,match", [
    ((4, 17, True), NotImplementedError, "at most 16 tracers"),
    ((8, 0, False), NotImplementedError, "at most 16 tracers"),
    ((2, 2, True), TypeError, "float32 or float64"),
])
def test_flux_plan_refuses(args, err, match):
    with pytest.raises(err, match=match):
        gm_cuda.launch_plan(*args)


def test_flux_plan_refuses_a_tile_over_the_card(monkeypatch):
    monkeypatch.setattr(cb, "SMEM_PER_BLOCK", 16 * 1024)
    with pytest.raises(ValueError, match="227 KB"):
        gm_cuda.launch_plan(8, 16, False)


def _gm_flux_setup():
    cfg = get_config("mini", hmix_tracer="gm", gm_transition_layer=False,
                     lsubmeso=False)
    return cfg, build_grid(cfg, "cpu")


@pytest.mark.parametrize("dtype,smem_cap,err,match", [
    (torch.float16, None, TypeError, "float32 or float64"),
    (torch.float64, 8 * 1024, ValueError, "shared memory a block"),
])
def test_slope_wrapper_refuses_before_building(no_build, monkeypatch, dtype,
                                               smem_cap, err, match):
    cfg, grid = _gm_flux_setup()
    if smem_cap is not None:
        monkeypatch.setattr(cb, "SMEM_PER_BLOCK", smem_cap)
    tmix = torch.zeros((2, cfg.km, cfg.ny, cfg.nx), dtype=dtype)
    with pytest.raises(err, match=match):
        gm_slope_cuda.slopes(cfg, grid, None, None, tmix.as_subclass(OnCard))


# 17 tracers are two launches (9 + 8), each tile planned before building
@pytest.mark.parametrize("nt,smem_cap,err,match", [
    (17, 8 * 1024, ValueError, "nt=9"),
    (2, 8 * 1024, ValueError, "shared memory a block"),
])
def test_flux_wrapper_refuses_before_building(no_build, monkeypatch, nt,
                                              smem_cap, err, match):
    cfg, grid = _gm_flux_setup()
    if smem_cap is not None:
        monkeypatch.setattr(cb, "SMEM_PER_BLOCK", smem_cap)
    f3 = (cfg.km, cfg.ny, cfg.nx)
    tx = torch.zeros((nt,) + f3)
    q = torch.zeros((2, 2) + f3)
    h = torch.zeros((2,) + f3)
    with pytest.raises(err, match=match):
        gm_cuda.flux_assembly(cfg, grid, None, tx.as_subclass(OnCard), tx,
                              tx, q, q, q, q, h, h, True)


@pytest.mark.parametrize("ny,nx,km", [(0, 4, 3), (3, 4, 0)])
def test_search_plan_refuses_an_empty_grid(ny, nx, km):
    with pytest.raises(ValueError, match="columns"):
        gm_tlt_cuda.launch_plan(ny, nx, km)


def test_search_plan_is_a_thread_a_column():
    assert gm_tlt_cuda.launch_plan(384, 320, 60) == (
        -(-384 * 320 // gm_tlt_cuda.THREADS), gm_tlt_cuda.THREADS)


@pytest.mark.parametrize("case,err,match", [
    ("float16", TypeError, "float32 or float64"),
    ("rb_shape", ValueError, "rb: shape"),
    ("kmt_dtype", TypeError, "KMT: dtype"),
])
def test_search_wrapper_refuses_before_building(no_build, case, err, match):
    cfg = get_config("mini")
    grid = build_grid(cfg, "cpu")
    km, ny, nx = cfg.km, cfg.ny, cfg.nx
    dt = torch.float16 if case == "float16" else torch.float64
    sla = torch.ones(2, km, ny, nx, dtype=dt).as_subclass(OnCard)
    dd = torch.ones(ny, nx, dtype=dt)
    rb = torch.ones(ny, nx + (case == "rb_shape"), dtype=dt)
    if case == "kmt_dtype":
        grid = grid.replace(KMT=grid.KMT.long())
    grid.__dict__["_gm_tlt_lev"] = torch.ones(2, km, dtype=dt)
    with pytest.raises(err, match=match):
        gm_tlt_cuda.transition_layer(cfg, grid, dd, sla, rb)
