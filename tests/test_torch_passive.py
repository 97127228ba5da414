"""The port's passive tracers (``passive_tracers``, ``gas_tracers``)
against the JAX package's, on the CPU in float64.

On the 'mini' grid with the production packages (ideal age, CFC-11 and
CFC-12) and with sf6 and irf beside them, the same seeded tracers and
forcing (10-m wind speed squared, ice fraction, atmospheric pressure and
the atmospheric mole fractions, all from a seed) go through both packages:
the interior sources, the surface fluxes (with ``tracer_atm`` and with the
packages' defaults) and the resets agree to rtol 1e-13, and the initial
values exactly. Without ``u10_sqr`` the gas fluxes are zero in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from pop2_tpu import gas_tracers as jgas  # noqa: E402
from pop2_tpu.config import get_config  # noqa: E402
from pop2_tpu.forcing import analytic_forcing as j_forcing  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid  # noqa: E402
from pop2_tpu.passive_tracers import PassiveTracers as JPassive  # noqa: E402

from pop2_tpu_torch import convert, gas_tracers as tgas  # noqa: E402
from pop2_tpu_torch.forcing import analytic_forcing as t_forcing  # noqa: E402
from pop2_tpu_torch.passive_tracers import PassiveTracers as TPassive  # noqa: E402

from tests.torch_port_helpers import jax_leaves, torch_cfg  # noqa: E402

PACKAGES = {"prod": ("iage", "cfc"), "all": ("iage", "cfc", "sf6", "irf")}
RTOL = 1e-13


class Pair:
    """One set of packages in both frameworks on the same 'mini' grid, with
    seeded tracers at two times and seeded gas-exchange forcing."""

    def __init__(self, packages, seed=3):
        nt = 2 + sum({"iage": 1, "cfc": 2, "sf6": 1, "irf": 1}[p]
                     for p in packages)
        self.jcfg = get_config("mini", nt=nt, passive_tracers=packages)
        self.tcfg = torch_cfg(self.jcfg)
        self.jgrid = j_build_grid(self.jcfg)
        self.tgrid = convert.grid_from_numpy(jax_leaves(self.jgrid),
                                             self.tcfg, "cpu")
        self.jp = JPassive(self.jcfg, packages)
        self.tp = TPassive(self.tcfg, packages)
        rng = np.random.RandomState(seed)
        km, ny, nx = self.jcfg.km, self.jcfg.ny, self.jcfg.nx
        mt = np.asarray(self.jgrid.kmask_t)
        t = 10.0 + 8.0 * rng.rand(km, ny, nx)
        s = 0.034 + 0.002 * rng.rand(km, ny, nx)
        self.old, self.cur = (
            np.concatenate([np.stack([t + d * rng.randn(km, ny, nx),
                                      s]),
                            rng.rand(nt - 2, km, ny, nx)]) * mt[None]
            for d in (0.1, 0.2))
        ngas = sum(n in ("CFC11", "CFC12", "SF6") for n in self.jp.names)
        self.gas = dict(
            u10_sqr=4.9e5 * (0.5 + rng.rand(ny, nx)),
            ifrac=rng.uniform(-0.2, 1.2, (ny, nx)),
            atm_press=np.where(rng.rand(ny, nx) < 0.5, 0.0,
                               1.0e6 * (1.0 + 0.02 * rng.randn(ny, nx))),
            tracer_atm=100.0 * (1.0 + rng.rand(ngas, 2)))

    def forcings(self, **fields):
        jf = j_forcing(self.jcfg, self.jgrid).replace(
            **{k: jnp.asarray(v) for k, v in fields.items()})
        tf = t_forcing(self.tcfg, self.tgrid).replace(
            **{k: torch.as_tensor(v) for k, v in fields.items()})
        return jf, tf


@pytest.fixture(scope="module")
def pairs():
    return {name: Pair(pk) for name, pk in PACKAGES.items()}


def _allclose(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("packages", list(PACKAGES))
def test_init_values_and_names_equal(pairs, packages):
    p = pairs[packages]
    assert p.tp.names == p.jp.names
    assert [q.slot0 for q in p.tp.packages] == [q.slot0
                                                for q in p.jp.packages]
    np.testing.assert_array_equal(p.tp.init_values(p.tcfg, p.tgrid),
                                  p.jp.init_values(p.jcfg, p.jgrid))


@pytest.mark.parametrize("packages", list(PACKAGES))
def test_set_interior_matches(pairs, packages):
    p = pairs[packages]
    jf, tf = p.forcings()
    want = p.jp.set_interior(p.jcfg, p.jgrid, jnp.asarray(p.old),
                             jnp.asarray(p.cur), forcing=jf)
    got = p.tp.set_interior(p.tcfg, p.tgrid, torch.as_tensor(p.old),
                            torch.as_tensor(p.cur), forcing=tf)
    _allclose(got, want, "set_interior")
    assert float(got.abs().max()) > 0.0  # the ideal age's source


@pytest.mark.parametrize("atm", ["tracer_atm", "default_atm"])
@pytest.mark.parametrize("packages", list(PACKAGES))
def test_set_sflux_matches(pairs, packages, atm):
    p = pairs[packages]
    fields = dict(p.gas)
    if atm == "default_atm":
        del fields["tracer_atm"]
    jf, tf = p.forcings(**fields)
    want = p.jp.set_sflux(p.jcfg, p.jgrid, jnp.asarray(p.old),
                          jnp.asarray(p.cur), jf)
    got = p.tp.set_sflux(p.tcfg, p.tgrid, torch.as_tensor(p.old),
                         torch.as_tensor(p.cur), tf)
    _allclose(got, want, "set_sflux")
    gas = [i for i, n in enumerate(p.tp.names)
           if n in ("CFC11", "CFC12", "SF6")]
    assert all(float(got[i].abs().max()) > 0.0 for i in gas)


def test_gas_fluxes_vanish_without_wind(pairs):
    p = pairs["prod"]
    jf, tf = p.forcings()
    want = p.jp.set_sflux(p.jcfg, p.jgrid, jnp.asarray(p.old),
                          jnp.asarray(p.cur), jf)
    got = p.tp.set_sflux(p.tcfg, p.tgrid, torch.as_tensor(p.old),
                         torch.as_tensor(p.cur), tf)
    assert float(got.abs().max()) == 0.0 == float(jnp.abs(want).max())


@pytest.mark.parametrize("packages", list(PACKAGES))
def test_reset_matches_and_leaves_its_argument(pairs, packages):
    p = pairs[packages]
    want = p.jp.reset(p.jcfg, p.jgrid, jnp.asarray(p.cur))
    arg = torch.as_tensor(p.cur).clone()
    got = p.tp.reset(p.tcfg, p.tgrid, arg)
    _allclose(got, want, "reset")
    np.testing.assert_array_equal(arg.numpy(), p.cur)  # out of place
    assert float(got[2, 0].abs().max()) == 0.0  # the age's surface reset


@pytest.mark.parametrize("name", ["CFC11", "CFC12", "SF6"])
def test_gas_coefficients_match(name):
    rng = np.random.RandomState(11)
    sst = rng.uniform(-5.0, 45.0, 50)
    sss = rng.uniform(30.0, 40.0, 50)
    tlat = rng.uniform(-90.0, 90.0, 50)
    for fj, ft, args in (
            (jgas.schmidt_number, tgas.schmidt_number, (sst,)),
            (jgas.solubility_0, tgas.solubility_0, (sst, sss))):
        np.testing.assert_allclose(
            ft(name, *(torch.as_tensor(a) for a in args)).numpy(),
            np.asarray(fj(name, *(jnp.asarray(a) for a in args))),
            rtol=RTOL)
    np.testing.assert_allclose(
        tgas.blend_hemispheres(torch.as_tensor(tlat), 265.0, 260.0).numpy(),
        np.asarray(jgas.blend_hemispheres(jnp.asarray(tlat), 265.0, 260.0)),
        rtol=RTOL)


def test_unknown_and_unported_packages_raise():
    """Every package of the JAX package is ported (ROADMAP.md Queue 1 item
    11f): a name outside the registry raises ``KeyError``, as the JAX
    package's does, and a tracer count the packages do not fill
    ``ValueError``."""
    cfg = torch_cfg(get_config("mini", nt=3, passive_tracers=("iage",)))
    with pytest.raises(ValueError, match="nt=4"):
        TPassive(cfg.with_(nt=4), ("iage",))
    with pytest.raises(KeyError, match="marbl"):
        TPassive(cfg, ("marbl",))
    with pytest.raises(ValueError, match="nt=3"):
        TPassive(cfg, ("abio_dic",))
