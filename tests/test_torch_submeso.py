"""The port's submesoscale scheme, the GM chain with it folded in, and GM
under a KPP boundary layer, against the JAX package on the CPU.

Seeded NumPy tracers (the stratified T/S of the JAX package's GM kernel
tests), boundary-layer and mixed-layer depths spanning several levels, on
grids with levels 10 m thick at the surface growing by half a level each
(``torch_port_helpers.stretched_pair``): a closed grid on a stepped bottom
and a tripole grid whose bottom has ocean across the fold
(``torch_port_helpers.fold_bottom``; the internal grid's top rows are land
and would hide a fault of the fold).

  - float64, 1e-12 of scale: ``submeso.streamfunction``,
    ``submeso_tendency``, the chain kernel's 2-D amplitudes
    (``gm_chain_pallas._submeso_amps``), ``gm.hdifft_gm`` with the KPP
    boundary layer (transition layer on and off), and the plain
    transition-layer search from the smoothed boundary layer (its integer
    fields equal);
  - float32: the port's ``hdifft_chain`` with the submesoscale fold-in
    (the chain's plain version with ``sm``) against the JAX package's
    Pallas chain kernel with ``with_sm`` in interpret mode, on the fold
    bottom, at 2e-5 of scale. This one case
    runs at 6 levels: the interpret mode unrolls the kernel's level loops,
    and at 10 levels it alone took 140 s of the suite; on the stretched
    levels the boundary layer still spans levels 2 to 5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import gm as jgm, gm_chain_pallas, gm_slope_pallas  # noqa: E402
from pop2_tpu import kpp as jkpp, submeso as jsub  # noqa: E402
from pop2_tpu import eos as jeos  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.grid import grid_bc as j_grid_bc  # noqa: E402

from pop2_tpu_torch import eos as teos, gm as tgm, gm_chain_cuda  # noqa: E402
from pop2_tpu_torch import gm_tlt_cuda, sample  # noqa: E402
from pop2_tpu_torch import submeso as tsub  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402

from tests.test_torch_gm import _Pallas, _flux_close  # noqa: E402
from tests.torch_port_helpers import (fold_bottom, scale_err,  # noqa: E402
                                      stepped_bottom, stretched_pair)

GM = dict(hmix_tracer="gm", gm_transition_layer=True,
          gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
          gm_kappa_isop_deep=0.2, gm_kappa_thic_deep=0.1,
          gm_ah=3.0e7, gm_ah_bolus=3.0e7, gm_ah_bkg_srfbl=3.0e7,
          lsubmeso=True, vmix="kpp")
# ny % 8 == 0: the Pallas interpret mode needs it
DIMS = dict(nx=32, ny=16, km=12)
KM_PALLAS = 6


class Pair:
    """A configuration in both packages on the stretched levels, with
    seeded tracers and boundary-layer and mixed-layer depths."""

    def __init__(self, tmp, ns, dtype, km):
        preset = "prod_full" if ns == "tripole" else "test"
        over = dict(GM, **DIMS, dtype=dtype)
        over["km"] = km
        if ns == "tripole":
            over.update(passive_tracers=(), nt=2)
        jcfg, self.tcfg, jg, tg = stretched_pair(get_config(preset, **over),
                                                 tmp)
        self.jcfg = jcfg
        if ns == "tripole":
            self.jg, self.tg = fold_bottom(jg, tg, jcfg, seed=6)
            assert (np.asarray(self.jg.KMT)[-2:] > 0).mean() > 0.5
        else:
            self.jg, self.tg = stepped_bottom(jg, tg, jcfg.ew_boundary, 2)
        self.jbc, self.tbc = j_grid_bc(jcfg), t_grid_bc(self.tcfg)
        npdt = np.float64 if dtype == "float64" else np.float32
        g = self.jg
        self.tmix = sample.stratified_tracers(
            g.kmask_t, g.vgrid.zt, g.TLAT, jcfg.nt, 3, npdt)
        rng = np.random.RandomState(5)
        zt = np.asarray(g.vgrid.zt)
        ocean = np.asarray(g.KMT) > 0
        lat = np.asarray(g.TLAT)
        top, bottom = zt[1 if km < 9 else 2], zt[min(8, km - 2)]
        self.hblt = ((top + (bottom - top) * (0.5 + 0.5 * np.cos(2 * lat)))
                     * ocean).astype(npdt)
        self.hmxl = (self.hblt * (0.8 + 0.4 * rng.rand(*ocean.shape))
                     ).astype(npdt)
        zt64 = np.asarray(g.vgrid.zt, np.float64)
        self.jr = jeos.build_ts_range(zt64, jcfg.jnp_dtype)
        self.tr = teos.build_ts_range(zt64, self.tcfg.torch_dtype)

    def j(self, *names):
        return [jnp.asarray(getattr(self, n)) for n in names]

    def t(self, *names):
        return [torch.as_tensor(getattr(self, n)) for n in names]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("submeso")
    return {(ns, dt): Pair(tmp, ns, dt, km) for ns, dt, km in (
        ("closed", "float64", DIMS["km"]), ("tripole", "float64", DIMS["km"]),
        ("tripole", "float32", KM_PALLAS))}


@pytest.mark.parametrize("ns", ["closed", "tripole"])
def test_submeso_matches(pairs, ns):
    p = pairs[(ns, "float64")]
    jt, jh = p.j("tmix", "hmxl")
    tt, th = p.t("tmix", "hmxl")
    want = jsub.streamfunction(p.jcfg, p.jg, p.jbc, p.jr, jt, hmxl=jh)
    got = tsub.streamfunction(p.tcfg, p.tg, p.tbc, p.tr, tt, hmxl=th)
    for g, w, name in zip(got, want, ("sfx", "sfy", "hls")):
        assert scale_err(g.numpy(), w) <= 1e-12, name
    want_gtk, want_hls = jsub.submeso_tendency(p.jcfg, p.jg, p.jbc, p.jr, jt,
                                               hmxl=jh)
    got_gtk, _ = tsub.submeso_tendency(p.tcfg, p.tg, p.tbc, p.tr, tt,
                                       hmxl=th)
    assert float(np.abs(np.asarray(want_gtk)).max()) > 0.0
    assert scale_err(got_gtk.numpy(), want_gtk) <= 1e-12
    assert scale_err(got_gtk[..., -2:, :].numpy(),
                     np.asarray(want_gtk)[..., -2:, :]) <= 1e-12
    # the chain kernel's operand: the amplitudes, and the streamfunction
    # they give
    amps = tsub.amplitudes(p.tcfg, p.tg, p.tbc, p.tr, tt, hmxl=th)
    jamps = gm_chain_pallas._submeso_amps(p.jcfg, p.jg, p.jbc, p.jr, jt, jh)
    for g, w in zip(amps, jamps):
        assert scale_err(g.numpy(), w) <= 1e-12
    for g, w in zip(tsub.sf_from_amps(p.tg, amps), want[:2]):
        assert scale_err(g.numpy(), w) <= 1e-12


# GM on a tripole grid runs with the transition layer, through the chain
# (supported.py: Queue 2 kernel 6)
@pytest.mark.parametrize("ns,tl", [("closed", True), ("closed", False),
                                   ("tripole", True)])
def test_hdifft_gm_under_the_boundary_layer(pairs, ns, tl):
    """GM with the KPP boundary layer: the smoothed layer as the diabatic
    depth with the transition layer, the depth of the near-surface taper
    without it; ``gm.hdifft_gm`` on the closed grid, the fused chain's
    plain version on the tripole one."""
    p = pairs[(ns, "float64")]
    jcfg = p.jcfg.with_(gm_transition_layer=tl)
    tcfg = p.tcfg.with_(gm_transition_layer=tl, lsubmeso=False)
    jt, jh = p.j("tmix", "hblt")
    tt, th = p.t("tmix", "hblt")
    want = jgm.hdifft_gm(jcfg, p.jg, p.jbc, p.jr, jt, hblt=jh,
                         use_kernels=False)
    if ns == "tripole":
        got = gm_chain_cuda.hdifft_chain(tcfg, p.tg, p.tbc, p.tr, tt,
                                         hblt=th)
    else:
        got = tgm.hdifft_gm(tcfg, p.tg, p.tbc, p.tr, tt, hblt=th)
    for name in ("gtk", "vdc_gm", "kappa_isop", "kappa_thic", "hor_diff",
                 "dia_depth", "tlt_thick", "int_depth"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
            continue
        assert scale_err(getattr(got, name).numpy(), w) <= 1e-12, name


@pytest.mark.parametrize("ns", ["closed", "tripole"])
def test_search_from_the_boundary_layer(pairs, ns):
    """The plain search (the search kernel's plain version, which its
    wrapper takes on CPU tensors) from the smoothed boundary-layer depth:
    integer fields equal, depths to 1e-12, and the search goes below the
    first levels."""
    p = pairs[(ns, "float64")]
    jt, jh = p.j("tmix", "hblt")
    tt, th = p.t("tmix", "hblt")
    _, _, _, slx, sly = jgm._slopes(p.jcfg, p.jg, p.jbc, p.jr, jt)
    sla = jgm._sla(p.jcfg, p.jg, slx, sly)
    dd, _ = jkpp.smooth_hblt(p.jcfg, p.jg, p.jbc, jh)
    want = jgm.transition_layer(p.jcfg, p.jg, dd, sla,
                                jgm._rossby_radius(p.jg))
    tdd = tgm.diabatic_depth(p.tcfg, p.tg, p.tbc, th)
    got = gm_tlt_cuda.transition_layer(p.tcfg, p.tg, tdd,
                                       torch.as_tensor(np.array(sla)),
                                       tgm._rossby_radius(p.tg))
    for name in ("k_level", "ztw"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("diabatic_depth", "thickness", "interior_depth"):
        assert scale_err(getattr(got, name).numpy(),
                         getattr(want, name)) <= 1e-12, name
    assert int(got.k_level.max()) >= 5


def test_chain_with_sm_matches_pallas_interpret_f32(pairs):
    """The port's fused GM tendency with the submesoscale fold-in (plain
    chain with ``sm`` on CPU tensors) against the JAX package's Pallas
    chain kernel with ``with_sm`` in interpret mode, on the fold bottom:
    GTK and VDC_GM within 2e-5 of scale everywhere, the fold's two top rows
    included (the JAX package's chain test allows 5e-5 of scale or 5 % of
    the value)."""
    p = pairs[("tripole", "float32")]
    jt, jh, jm = p.j("tmix", "hblt", "hmxl")
    tt, th, tm = p.t("tmix", "hblt", "hmxl")
    with _Pallas(gm_chain_pallas, gm_slope_pallas):
        assert gm_chain_pallas.available(p.jcfg, p.jg)
        want, sm_included = gm_chain_pallas.hdifft_chain(
            p.jcfg, p.jg, p.jbc, p.jr, jt, hblt=jh, hmxl=jm)
    assert sm_included
    before = gm_chain_cuda.launches
    got = gm_chain_cuda.hdifft_chain(p.tcfg, p.tg, p.tbc, p.tr, tt, hblt=th,
                                     hmxl=tm)
    assert gm_chain_cuda.launches == before
    band = dict(abs_band=2e-5, rel_band=0.0)
    _flux_close(got.gtk.numpy(), want.gtk, "gtk", **band)
    _flux_close(got.gtk[..., -2:, :].numpy(),
                np.asarray(want.gtk)[..., -2:, :], "gtk top rows", **band)
    _flux_close(got.vdc_gm.numpy(), want.vdc_gm, "vdc_gm", **band)
    # without the fold-in the result moves beyond that band
    no_sm = gm_chain_cuda.hdifft_chain(
        p.tcfg.with_(lsubmeso=False), p.tg, p.tbc, p.tr, tt, hblt=th)
    with pytest.raises(AssertionError):
        _flux_close(no_sm.gtk.numpy(), want.gtk, "gtk", **band)
