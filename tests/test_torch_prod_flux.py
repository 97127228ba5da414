"""The production configuration without GM's transition layer (prod_flux)
as a whole: the port's ``Model`` against ``pop2_tpu.model.Model`` on the
CPU in float64.

prod_flux is ``get_config("prod_full", gm_transition_layer=False)``: all
of prod_full (``test_torch_prod_full.py``: nt = 5 with the ideal age and
the CFC tracers under a 10-m wind) with GM through the plain chain and the
flux-assembly kernel's plain version, which on the tripole grid folds the
north face's skew weights into the top row's north neighbour, and with the
submesoscale tendency outside the chain. Same grids, state, forcing and
bands as prod_full; the file grid carries flux across the fold (its top
row's north faces have length, where the internal grid's lie on the pole).
"""

import pytest

from tests.test_torch_prod_full import check_step1, check_step5, make_runs

PROD_FLUX = dict(gm_transition_layer=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory.mktemp("prod_flux"), **PROD_FLUX)


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_flux_step1_machine_precision(runs, grid):
    assert not runs[grid].tcfg.gm_transition_layer
    check_step1(runs[grid])


@pytest.mark.parametrize("grid", ["internal", "fold"])
def test_prod_flux_step5_parity(runs, grid):
    check_step5(runs[grid])
