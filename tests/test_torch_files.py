"""The port's file inputs against the JAX package's on the CPU: the gx-class
grid generator, the POP-format grid, topography, vertical-grid and binary
field files, the reference's text input templates, the file branches of
``grid.build_grid``, the 9-point SPAI and file preconditioners, and whole
steps of the production and gx3v7 menus on generated file grids.

Bands: files byte-identical; every ``Grid`` leaf expected bitwise, allowed
1e-14 relative; the SPAI stencil 1e-13 of each field's scale; ChronGear
with it the same iterations and the solution within 1e-12 of scale; whole
steps PARITY.md's bands, 1e-11 after the first step and 1e-7 after five,
each field relative to its largest value and each tracer to its own
(float64).
"""

import dataclasses
import filecmp
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import eos as jeos  # noqa: E402
from pop2_tpu import gridgen as jgridgen  # noqa: E402
from pop2_tpu import production as jproduction  # noqa: E402
from pop2_tpu import solvers as jsolvers  # noqa: E402
from pop2_tpu.barotropic import diagonal_correction as jdiag_corr  # noqa: E402
from pop2_tpu.config import (OverflowSpec as JSpec, RegionBox as JBox,  # noqa: E402
                             SolverConfig as JSolverConfig, get_config)
from pop2_tpu.grid import build_grid as j_build_grid, grid_bc as j_bc  # noqa: E402
from pop2_tpu.io import grid_files as jgf  # noqa: E402
from pop2_tpu.io import input_templates as jit  # noqa: E402
from pop2_tpu.io import pop_binary as jpb  # noqa: E402
from pop2_tpu.model import Model as JModel  # noqa: E402

from pop2_tpu_torch import convert, gridgen, production, solvers  # noqa: E402
from pop2_tpu_torch import supported  # noqa: E402
from pop2_tpu_torch.barotropic import diagonal_correction  # noqa: E402
from pop2_tpu_torch.grid import build_grid, grid_bc  # noqa: E402
from pop2_tpu_torch.io import grid_files, input_templates, pop_binary  # noqa: E402
from pop2_tpu_torch.model import Model as TModel  # noqa: E402

from tests.torch_port_helpers import jax_leaves, torch_cfg  # noqa: E402

NX, NY, KM = 40, 24, 12
NSTEPS = 5
U10_SQR = 4.9e5  # cm^2/s^2: a 7 m/s wind
FIELDS = ("u_cur", "v_cur", "psurf_cur", "ubtrop_cur", "vbtrop_cur")


@pytest.fixture(scope="module")
def gx_files(tmp_path_factory):
    """One 40x24x12 gx-class grid written by the JAX package's generator."""
    return jgridgen.generate_gx_files(
        str(tmp_path_factory.mktemp("gx")), NX, NY, KM)


def file_cfg(preset, files, **over):
    """The JAX package's ``preset`` on the generated file grid (``over``
    may name another grid option)."""
    kw = dict(nx=NX, ny=NY, km=KM, horiz_grid="file", vert_grid="file",
              topography="file", horiz_grid_file=files["horiz"],
              vert_grid_file=files["vert"], topography_file=files["topo"],
              dtype="float64")
    return get_config(preset, **{**kw, **over})


# -- files ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 24, 12), (64, 48, 12)])
@pytest.mark.parametrize("seed", [0, 5])
def test_generate_gx_files_byte_identical(tmp_path, shape, seed):
    nx, ny, km = shape
    want = jgridgen.generate_gx_files(str(tmp_path / "jax"), nx, ny, km,
                                      seed=seed)
    got = gridgen.generate_gx_files(str(tmp_path / "port"), nx, ny, km,
                                    seed=seed)
    assert set(got) == set(want)
    for key in want:
        assert os.path.basename(got[key]) == os.path.basename(want[key])
        assert filecmp.cmp(got[key], want[key], shallow=False), key
    kmt = grid_files.read_topography(got["topo"], ny, nx)
    assert 0.5 < (kmt > 0).mean() < 0.9 and kmt.max() == km
    assert kmt[kmt > 0].min() == 3  # gridgen's 3-level minimum


def _pop_fields(rng, ny, nx):
    return {"SSH": rng.randn(ny, nx), "TEMP": rng.randn(3, ny, nx),
            "KMT": rng.randint(0, 9, (ny, nx)).astype(np.float64)}


@pytest.mark.parametrize("kind", ["horiz", "topo", "vert", "pop_binary"])
def test_file_round_trips_and_errors(tmp_path, kind):
    """Each writer writes the JAX package's bytes, each reader reads them
    back, and each raises where the JAX package's raises, alike."""
    rng = np.random.RandomState(11)
    ny, nx, km = 6, 7, 5
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "horiz":
        fields = {n: rng.randn(ny, nx) for n in grid_files.HORIZ_RECORDS}
        assert grid_files.HORIZ_RECORDS == jgf.HORIZ_RECORDS
        for dt in (">f8", "<f8"):
            jgf.write_horiz_grid(jp, fields, dtype=dt)
            grid_files.write_horiz_grid(tp, fields, dtype=dt)
            assert filecmp.cmp(jp, tp, shallow=False)
            back = grid_files.read_horiz_grid(tp, ny, nx, dtype=dt)
            for n in fields:
                np.testing.assert_array_equal(back[n], fields[n])
        readers = (lambda p: grid_files.read_horiz_grid(p, ny + 1, nx),
                   lambda p: jgf.read_horiz_grid(p, ny + 1, nx))
    elif kind == "topo":
        kmt = rng.randint(0, km + 1, (ny, nx)).astype(np.int32)
        for dt in (">i4", "<i4"):
            jgf.write_topography(jp, kmt, dtype=dt)
            grid_files.write_topography(tp, kmt, dtype=dt)
            assert filecmp.cmp(jp, tp, shallow=False)
            back = grid_files.read_topography(tp, ny, nx, dtype=dt)
            assert back.dtype == np.int32
            np.testing.assert_array_equal(back, kmt)
        readers = (lambda p: grid_files.read_topography(p, ny + 1, nx),
                   lambda p: jgf.read_topography(p, ny + 1, nx))
    elif kind == "vert":
        dz = 1000.0 * 1.3 ** np.arange(km) + rng.rand(km)
        jgf.write_vert_grid(jp, dz)
        grid_files.write_vert_grid(tp, dz)
        assert filecmp.cmp(jp, tp, shallow=False)
        np.testing.assert_array_equal(grid_files.read_vert_grid(tp, km),
                                      jgf.read_vert_grid(jp, km))
        readers = (lambda p: grid_files.read_vert_grid(p, km + 1),
                   lambda p: jgf.read_vert_grid(p, km + 1))
    else:
        fields = _pop_fields(rng, ny, nx)
        attrs = {"title": "round trip", "calendar": "noleap"}
        jpb.write_pop_binary(jp, ny, nx, fields, attrs)
        pop_binary.write_pop_binary(tp, ny, nx, fields, attrs)
        assert filecmp.cmp(jp, tp, shallow=False)
        assert filecmp.cmp(jp + ".hdr", tp + ".hdr", shallow=False)
        back, want = (pop_binary.read_pop_binary(tp, ny, nx),
                      jpb.read_pop_binary(jp, ny, nx))
        assert list(back) == list(want) == list(fields)
        for n in fields:
            np.testing.assert_array_equal(back[n], want[n])
            np.testing.assert_array_equal(back[n], fields[n])
        # a field of the wrong shape, a file without its header, a
        # truncated record
        for write in (pop_binary.write_pop_binary, jpb.write_pop_binary):
            with pytest.raises(ValueError, match="trailing dims"):
                write(str(tmp_path / "bad"), ny, nx,
                      {"X": np.zeros((ny + 1, nx))})
        os.remove(tp + ".hdr")
        for read in (pop_binary.read_pop_binary, jpb.read_pop_binary):
            with pytest.raises(FileNotFoundError, match="header"):
                read(tp, ny, nx)
        with open(jp, "r+b") as f:
            f.truncate(8 * ny * nx * 2)
        for read in (pop_binary.read_pop_binary, jpb.read_pop_binary):
            with pytest.raises(ValueError, match="truncated"):
                read(jp, ny, nx)
        return
    # a file too short for the asked dimensions: the same error, worded alike
    errors = []
    for read in readers:
        with pytest.raises(ValueError) as err:
            read(tp)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


OVERFLOW_FILE = """\
 Overflow regions for a test grid, in the overflows_infile layout
 (prose header, then the data after the second dashed line)
 ---------------------------------------------------------------------
 indices are 1-based Fortran T-grid indices
 ---------------------------------------------------------------------
 2                        ! number of overflows
 1 'Denmark Strait'       ! number and name
 65.0                     ! latitude (degrees)
 5.0e6                    ! width (cm)
 5.0e4                    ! source thickness (cm)
 2.0e7                    ! distance strait to shelf break (cm)
 0.01                     ! bottom slope
 0.003                    ! bottom drag
 2                        ! kmt changes
 10 12 5 7
 11 12 5 7
 8 12 10 13 1 6           ! inflow box
 9 12 11 13 2 5           ! source box
 12 14 12 14 3 8          ! entrainment box
 2                        ! source points
 10 12 5 1
 11 12 5 2
 1                        ! entrainment points
 12 13 6 3
 2                        ! product sets
 2
 14 15 8 4
 15 15 8 1
 1
 16 17 10 2
 2 'Ross Sea'
 -76.5
 4.0e6
 6.0e4
 1.5e7
 0.02
 0.003
 0
 20 24 2 4 1 5
 21 23 2 3 2 4
 22 25 3 5 3 7
 1
 21 3 4 3
 1
 23 4 5 1
 1
 1
 25 5 8 2
"""


def _write_templates(d):
    """A templates directory in the reference's formats (written here)."""
    rng = np.random.RandomState(3)
    dz = np.concatenate([np.full(16, 1000.0),
                         1000.0 + np.cumsum(rng.rand(44) * 1500.0)])
    zw = np.cumsum(dz)
    with open(os.path.join(d, "gx1v7_vert_grid"), "w") as f:
        for a, b, c in zip(dz, zw - 0.5 * dz, zw):
            f.write(f"  {a:.4f}  {b / 100.0:.4f}  {c / 100.0:.4f}\n")
    with open(os.path.join(d, "gx1v7_depth_accel"), "w") as f:
        f.write("".join(f"{1.0 + 0.1 * k:.2f}\n" for k in range(60)))
    with open(os.path.join(d, "gx1v7_region_ids"), "w") as f:
        f.write("  1 'Southern Ocean'   0.0   0.0  0.0\n"
                "  2 'Pacific Ocean'    0.0   0.0  0.0\n"
                " -12 'Red Sea'        14.0  47.0  3.0e15\n"
                " -13 'Baltic Sea'     57.0  20.0  2.5e15\n")
    with open(os.path.join(d, "gx1v7_transport_contents"), "w") as f:
        f.write("3\n"
                "297 297  24  47  1 60 merid Drake Passage\n"
                "200 210 300 300  1 60 zonal Bering Strait\n"
                "  5  9  10  10  2 30 zonal\n")
    with open(os.path.join(d, "gx1v7_tavg_contents"), "w") as f:
        f.write("1  TEMP\n1  SALT\n2  SST\n# comment\n3  HMXL\n")
    with open(os.path.join(d, "gx1v7_overflow"), "w") as f:
        f.write(OVERFLOW_FILE)


PARSERS = ("read_vert_grid", "read_depth_accel", "read_region_ids",
           "read_transport_contents", "read_tavg_contents", "read_overflows")
FILE_OF = {"read_vert_grid": "gx1v7_vert_grid",
           "read_depth_accel": "gx1v7_depth_accel",
           "read_region_ids": "gx1v7_region_ids",
           "read_transport_contents": "gx1v7_transport_contents",
           "read_tavg_contents": "gx1v7_tavg_contents",
           "read_overflows": "gx1v7_overflow"}


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("templates"))
    _write_templates(d)
    return d


@pytest.mark.parametrize("parser", PARSERS)
def test_input_template_parser_matches(templates, parser):
    path = os.path.join(templates, FILE_OF[parser])
    got = getattr(input_templates, parser)(path)
    want = getattr(jit, parser)(path)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert got.size == 60
        return
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if parser == "read_overflows":
            # the port's frozen dataclasses against the JAX package's,
            # field by field (region boxes included)
            gd, wd = vars(g), vars(w)
            assert set(gd) == set(wd)
            for k in wd:
                if isinstance(wd[k], JBox):
                    assert vars(gd[k]) == vars(wd[k]), k
                else:
                    assert gd[k] == wd[k], k
        else:
            assert tuple(g) == tuple(w) and g == w
            if parser == "read_region_ids":
                assert g.is_marginal_sea == w.is_marginal_sea
    if parser == "read_overflows":
        assert torch_cfg(get_config("mini", overflows=want)).overflows \
            == got


def test_production_config_reads_templates(templates):
    """Where a templates directory holds the vertical grid and the overflow
    geometry, the port attaches both as the JAX package does."""
    want = torch_cfg(jproduction.get_production_config(templates=templates))
    got = production.get_production_config(templates=templates)
    assert got == want
    assert got.vert_grid == "file" and len(got.overflows) == 2
    assert got.vert_grid_file == os.path.join(templates, "gx1v7_vert_grid")
    assert supported.unsupported(got) == []
    # overrides come after the templates, as in the JAX package
    over = production.get_production_config(templates=templates,
                                            overflows=())
    assert over == torch_cfg(jproduction.get_production_config(
        templates=templates, overflows=()))
    assert over.overflows == () and over.vert_grid == "file"


# -- the file grid --------------------------------------------------------

def _with_angle(files, tmp, seed):
    """The generated horizontal grid with a seeded nonzero ANGLE (values
    on both sides of the branch cut) written into its seventh record."""
    hg = jgf.read_horiz_grid(files["horiz"], NY, NX)
    rng = np.random.RandomState(seed)
    hg["ANGLE"] = rng.uniform(-np.pi, np.pi, (NY, NX))
    path = str(tmp / "horiz_angle")
    jgf.write_horiz_grid(path, hg)
    return dict(files, horiz=path)


def assert_grids_equal(tgrid, jgrid):
    """Every leaf of the port's grid against the JAX package's: integer and
    mask leaves equal, floating leaves expected bitwise and allowed 1e-14
    relative. Returns the worst relative difference."""
    jl = jax_leaves(jgrid)
    tl = dict(tgrid.leaves())
    assert set(jl) <= set(tl), sorted(set(jl) - set(tl))
    worst = 0.0
    for name, want in jl.items():
        got = tl[name].numpy()
        assert got.shape == want.shape, name
        if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0,
                                   err_msg=name)
        scale = np.abs(want).max() or 1.0
        worst = max(worst, float(np.abs(got - want).max() / scale))
    return worst


@pytest.mark.parametrize("ns", ["closed", "tripole"])
@pytest.mark.parametrize("angle", ["zero", "seeded"])
def test_build_grid_from_files_matches(gx_files, tmp_path, ns, angle):
    files = gx_files if angle == "zero" else _with_angle(gx_files, tmp_path,
                                                         17)
    jcfg = file_cfg("gx3v7", files, ns_boundary=ns)
    jgrid = j_build_grid(jcfg)
    tgrid = build_grid(torch_cfg(jcfg), "cpu")
    # expected bitwise (the same float64 NumPy arithmetic), allowed 1e-14
    assert assert_grids_equal(tgrid, jgrid) <= 1e-14
    # the file grid's own figures reached the grid: the spacing varies by
    # row, ANGLE and ANGLET are the file's, closed edges are land
    dyu = tgrid.DYU.numpy()
    assert dyu[1:-1, 0].max() > 1.5 * dyu[1:-1, 0].min()
    hg = jgf.read_horiz_grid(files["horiz"], NY, NX)
    np.testing.assert_array_equal(tgrid.ANGLE.numpy(), hg["ANGLE"])
    if angle == "seeded":
        assert np.abs(tgrid.ANGLET.numpy()[1:]).max() > 0.1
    kmt = tgrid.KMT.numpy()
    raw = jgf.read_topography(files["topo"], NY, NX)
    if ns == "closed":
        assert not kmt[0].any() and not kmt[-1].any()
        np.testing.assert_array_equal(kmt[1:-1], raw[1:-1])
    else:
        np.testing.assert_array_equal(kmt, raw)
        # the tripole DYU correction on the top row
        np.testing.assert_array_equal(dyu[-1], tgrid.HTE.numpy()[-1])


def test_overflow_wet_region_rule_under_file_topography(gx_files):
    """The overflows' wet-region rule runs on the internal topography only;
    their kmt pop-ups run on every topography."""
    # a box on the internal topography's land (110-150 E, north of 60 S)
    box = JBox(kmin=0, kmax=KM - 2, jmin=8, jmax=10, imin=12, imax=14)
    spec = JSpec(name="box", lat=60.0, width=5e6, source_thick=5e4,
                 distnc_str_ssb=2e7, bottom_slope=0.01, bottom_drag=0.003,
                 inf=box, src=box, ent=box, prd=box,
                 kmt_changes=((20, 12, 0, 4),),
                 src_pts=((13, 9, 3, 1),), ent_pts=((13, 10, 3, 2),),
                 prd_sets=(((14, 9, 5, 3),),))
    raw = jgf.read_topography(gx_files["topo"], NY, NX)
    for topo in ("file", "internal"):
        over = {} if topo == "file" else dict(
            horiz_grid="internal", topography="internal", flat_bottom=True)
        jcfg = file_cfg("mini", gx_files, overflows=(spec,), **over)
        tcfg = torch_cfg(jcfg)
        jkmt = np.asarray(j_build_grid(jcfg).KMT)
        tkmt = build_grid(tcfg, "cpu").KMT.numpy()
        np.testing.assert_array_equal(tkmt, jkmt)
        plain = build_grid(tcfg.with_(overflows=()), "cpu").KMT.numpy()
        assert tkmt[12, 20] == 4  # the pop-up
        changed = tkmt != plain
        changed[12, 20] = False
        if topo == "file":
            np.testing.assert_array_equal(plain, raw)
            assert not changed.any()  # no wet regions on the file's KMT
        else:
            assert changed.any()


# -- the 9-point preconditioners ------------------------------------------

@pytest.fixture(scope="module")
def spai_setup(gx_files):
    """The leapfrog operator of the gx3v7 menu on the file grid in both
    packages, their SPAI stencils and a right-hand side."""
    # a convergence check every iteration, so that the iteration counts of
    # the SPAI and the diagonal solves tell apart
    jcfg = file_cfg("gx3v7", gx_files, solver=JSolverConfig(
        preconditioner="spai", convergence_check_freq=1))
    tcfg = torch_cfg(jcfg)
    jgrid = j_build_grid(jcfg)
    tgrid = build_grid(tcfg, "cpu")
    jop = jsolvers.make_operator(jgrid, jdiag_corr(jcfg, jgrid, True))
    top = solvers.make_operator(tgrid, diagonal_correction(tcfg, tgrid,
                                                           True))
    rng = np.random.RandomState(5)
    mask = np.asarray(jgrid.RCALCT)
    b = rng.randn(NY, NX) * mask * 1e12  # well above the tolerance
    return dict(jcfg=jcfg, tcfg=tcfg, jop=jop, top=top, b=b,
                jp=jsolvers.build_spai9(jcfg, jop),
                tp=solvers.build_spai9(tcfg, top))


def test_build_spai9_matches(spai_setup):
    s = spai_setup
    jp, tp = s["jp"], s["tp"]
    assert isinstance(tp, solvers.Precond9)
    assert tp._fields == jsolvers.Precond9._fields
    for name in tp._fields:
        got, want = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        scale = np.abs(want).max() or 1.0
        assert np.abs(got - want).max() <= 1e-13 * scale, name
    # carried across from the JAX package's stencil
    carried = convert.precond_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    for name in tp._fields:
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    # PCSI's bounds under the stencil, both packages
    bc, jbc = grid_bc(s["tcfg"]), j_bc(s["jcfg"])
    got = solvers.pcg_lanczos_eigs(s["tcfg"], s["top"], bc, tp)
    want = jsolvers.pcg_lanczos_eigs(s["jcfg"], s["jop"], jbc, jp)
    assert got[0] > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_file_precond_equals_spai_bitwise(spai_setup, tmp_path):
    """The stencil written to an .npz and read back as the 'file'
    preconditioner solves bitwise as the SPAI stencil, and a Model with
    each builds the same stencil."""
    s = spai_setup
    path = str(tmp_path / "precond.npz")
    np.savez(path, **{k: v.numpy() for k, v in s["tp"]._asdict().items()})
    loaded = solvers.load_precond(path, torch.float64, "cpu")
    bc = grid_bc(s["tcfg"])
    b = torch.as_tensor(s["b"])
    x0 = torch.zeros_like(b)
    cfg_file = s["tcfg"].with_(solver=dataclasses.replace(
        s["tcfg"].solver, preconditioner="file", preconditioner_file=path))
    x_spai, m_spai, _ = solvers.chron_gear(s["tcfg"], s["top"], bc, x0, b,
                                           s["tp"])
    x_file, m_file, _ = solvers.chron_gear(cfg_file, s["top"], bc, x0, b,
                                           loaded)
    assert m_file == m_spai
    assert torch.equal(x_file, x_spai)
    m_a = TModel(s["tcfg"], device="cpu")
    m_b = TModel(cfg_file, device="cpu")
    for name in solvers.Precond9._fields:
        assert torch.equal(getattr(m_a.precond, name),
                           getattr(m_b.precond, name))
    # 'file' without a file is the diagonal preconditioner, as in the JAX
    # package
    assert TModel(cfg_file.with_(solver=dataclasses.replace(
        cfg_file.solver, preconditioner_file=None)),
        device="cpu").precond is None


def test_chrongear_with_spai_matches_jax(spai_setup):
    s = spai_setup
    jx, jm, _ = jsolvers.chron_gear(s["jcfg"], s["jop"], j_bc(s["jcfg"]),
                                    jnp.zeros((NY, NX)), jnp.asarray(s["b"]),
                                    precond=s["jp"])
    tx, tm, _ = solvers.chron_gear(s["tcfg"], s["top"], grid_bc(s["tcfg"]),
                                   torch.zeros(NY, NX),
                                   torch.as_tensor(s["b"]), s["tp"])
    # the diagonal run, for the iterations the stencil saves
    _, m_diag, _ = solvers.chron_gear(
        s["tcfg"].with_(solver=dataclasses.replace(
            s["tcfg"].solver, preconditioner="diagonal")), s["top"],
        grid_bc(s["tcfg"]), torch.zeros(NY, NX), torch.as_tensor(s["b"]))
    assert tm == int(jm) and 0 < tm < m_diag, (tm, int(jm), m_diag)
    jx = np.asarray(jx)
    assert np.abs(tx.numpy() - jx).max() <= 1e-12 * np.abs(jx).max()


# -- whole steps on file grids --------------------------------------------

class FileRun:
    """One configuration on the generated file grid in both packages, each
    building its own grid from the files, from the same state (noise in T,
    a third of the surface below freezing where the menu forms ice) and
    forcing (a heat flux that cools part of the points, a 7 m/s wind);
    NSTEPS steps of each."""

    def __init__(self, jcfg):
        self.jcfg, self.tcfg = jcfg, torch_cfg(jcfg)
        jm = JModel(jcfg)
        g = jm.grid
        mt = np.asarray(g.kmask_t)
        rng = np.random.RandomState(7)
        leaves = jax_leaves(jm.initial_state())
        tr = leaves["tracer_cur"].copy()
        tr[0] += 0.1 * rng.randn(*tr[0].shape) * mt
        if jcfg.liceform:
            cold = rng.rand(*tr[0, 0].shape) < 0.3
            tr[0, 0] = np.where(mt[0], np.where(cold, -2.5, tr[0, 0]), 0.0)
        if jcfg.nt > 2:
            tr[2] = 10.0 * rng.rand(*tr[2].shape) * mt  # an ideal age
        rho = np.asarray(jnp.where(g.kmask_t, jeos.state(
            jcfg, g.vgrid.pressz, jnp.asarray(tr[0]), jnp.asarray(tr[1]),
            jm.ts_range), 0.0))
        leaves.update(tracer_cur=tr, tracer_old=tr, rho_cur=rho,
                      rho_old=rho)
        shape = mt.shape[1:]
        heat = 5.0e-4 * np.abs(rng.randn(*shape))
        cool = rng.rand(*shape) < 0.4
        stf = np.zeros((jcfg.nt,) + shape)
        stf[0] = np.where(cool, -heat, 0.2 * heat) * mt[0]
        extra = dict(stf=stf,
                     shf_qsw=2.0e-4 * np.abs(rng.randn(*shape)) * mt[0])
        if jcfg.passive_tracers:
            extra.update(u10_sqr=np.full(shape, U10_SQR),
                         ifrac=np.zeros(shape))
        state = jm.initial_state().replace(
            **{k: jnp.asarray(leaves[k]) for k in
               ("tracer_cur", "tracer_old", "rho_cur", "rho_old")})
        forcing = jm.forcing.replace(
            **{k: jnp.asarray(v) for k, v in extra.items()})
        self.jsteps = []
        for _ in range(NSTEPS):
            state, _ = jm.advance(state, forcing)
            self.jsteps.append(jax_leaves(state))
        self.jgrid = g

        tm = TModel(self.tcfg, device="cpu")
        self.tgrid = tm.grid
        forcing = tm.forcing.replace(
            **{k: torch.as_tensor(v) for k, v in extra.items()})
        state = convert.state_from_numpy(leaves, self.tcfg, "cpu")
        self.tsteps = []
        for _ in range(NSTEPS):
            state, _ = tm.advance(state, forcing)
            self.tsteps.append(state)


def rel_diffs(state, want):
    """Each field's largest difference over its largest value; each tracer
    on its own scale."""
    out = {k: float(np.abs(getattr(state, k).numpy() - want[k]).max()
                    / (np.abs(want[k]).max() or 1.0)) for k in FIELDS}
    got, w = state.tracer_cur.numpy(), want["tracer_cur"]
    for n in range(w.shape[0]):
        out[f"tracer{n}"] = float(np.abs(got[n] - w[n]).max()
                                  / (np.abs(w[n]).max() or 1.0))
    return out


MENUS = {
    # the production menu (prod_full: tripole, KPP, GM with the transition
    # layer and submeso, upwind3, anisotropic viscosity, frazil ice, the
    # ideal age and CFCs, PCSI with FSPAI)
    "prod_full": lambda files: file_cfg("prod_full", files),
    # the gx3v7 preset's menu (closed north edge, KPP, GM with constant
    # kappas through the flux assembly, anisotropic viscosity, ChronGear)
    "gx3v7": lambda files: file_cfg("gx3v7", files),
}


@pytest.fixture(scope="module")
def file_runs(gx_files):
    return {name: FileRun(make(gx_files)) for name, make in MENUS.items()}


@pytest.mark.parametrize("menu", list(MENUS))
def test_file_grid_step1_machine_precision(file_runs, menu):
    r = file_runs[menu]
    assert_grids_equal(r.tgrid, r.jgrid)
    diffs = rel_diffs(r.tsteps[0], r.jsteps[0])
    assert max(diffs.values()) <= 1e-11, diffs


@pytest.mark.parametrize("menu", list(MENUS))
def test_file_grid_step5_parity(file_runs, menu):
    r = file_runs[menu]
    diffs = rel_diffs(r.tsteps[-1], r.jsteps[-1])
    assert max(diffs.values()) <= 1e-7, diffs
    for s in r.tsteps:
        for name, t in s.leaves():
            assert bool(torch.isfinite(t).all()), name
