"""The port's barotropic operator and elliptic solvers against the JAX
package's, on the CPU in float64 on the 'mini' grid: the same operator, the
same seeded right-hand side and first guess in both; the iteration must stop
at the same iteration number (the port reads the residual only on the check
iterations, as the JAX ``lax.while_loop`` does) and give the same solution to
1e-10 of its scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pop2_tpu import barotropic as jbt, solvers as jsol  # noqa: E402
from pop2_tpu.config import SolverConfig, get_config  # noqa: E402
from pop2_tpu.grid import build_grid as j_build_grid, grid_bc as j_grid_bc  # noqa: E402

from pop2_tpu_torch import barotropic as tbt, solvers as tsol  # noqa: E402
from pop2_tpu_torch.config import SolverConfig as SolverConfigT  # noqa: E402
from pop2_tpu_torch.grid import build_grid as t_build_grid  # noqa: E402
from pop2_tpu_torch.grid import grid_bc as t_grid_bc  # noqa: E402
from pop2_tpu_torch.reductions import global_sum  # noqa: E402

from tests.torch_port_helpers import scale_err, torch_cfg  # noqa: E402


class Setup:
    def __init__(self, **solver_kw):
        self.jcfg = get_config("mini", solver=SolverConfig(**solver_kw))
        self.tcfg = torch_cfg(self.jcfg)
        self.jgrid = j_build_grid(self.jcfg)
        self.tgrid = t_build_grid(self.tcfg, "cpu")
        self.jbc, self.tbc = j_grid_bc(self.jcfg), t_grid_bc(self.tcfg)
        self.jop = jsol.make_operator(
            self.jgrid, jbt.diagonal_correction(self.jcfg, self.jgrid, True))
        self.top = tsol.make_operator(
            self.tgrid, tbt.diagonal_correction(self.tcfg, self.tgrid, True))
        rng = np.random.RandomState(11)
        mask = np.asarray(self.jgrid.RCALCT)
        # a right-hand side in the operator's range: A applied to a smooth-ish
        # random surface pressure, so the solve has a well-defined answer
        xtrue = rng.randn(*mask.shape) * 50.0 * mask
        self.b = np.array(jsol.apply_op(self.jop, jnp.asarray(xtrue),
                                          self.jbc))
        self.x0 = rng.randn(*mask.shape) * mask


@pytest.fixture(scope="module")
def setup():
    return Setup()


def test_operator_and_apply_op_match(setup):
    s = setup
    for name in ("center", "north", "east", "ne", "mask", "resid_norm"):
        np.testing.assert_allclose(getattr(s.top, name).numpy(),
                                   np.asarray(getattr(s.jop, name)),
                                   rtol=1e-14, atol=0, err_msg=name)
    want = jsol.apply_op(s.jop, jnp.asarray(s.x0), s.jbc)
    got = tsol.apply_op(s.top, torch.as_tensor(s.x0), s.tbc)
    assert scale_err(got.numpy(), np.asarray(want)) <= 1e-14
    # the precomputed shifted weights give the same product
    sh = tsol._shifted_weights(s.top, s.tbc)
    again = tsol.apply_op(s.top, torch.as_tensor(s.x0), s.tbc, sh)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("name", ["chron_gear", "pcg"])
@pytest.mark.parametrize("check_freq", [10, 7])
def test_cg_solvers_match(name, check_freq):
    s = Setup(convergence_check_freq=check_freq)
    xw, mw, rrw = getattr(jsol, name)(s.jcfg, s.jop, s.jbc,
                                      jnp.asarray(s.x0), jnp.asarray(s.b))
    xg, mg, rrg = getattr(tsol, name)(s.tcfg, s.top, s.tbc,
                                      torch.as_tensor(s.x0),
                                      torch.as_tensor(s.b))
    assert isinstance(mg, int) and mg == int(mw)
    assert 0 < mg < s.jcfg.solver.max_iterations and mg % check_freq == 0
    assert scale_err(xg.numpy(), np.asarray(xw)) <= 1e-10
    assert float(rrg) < tsol._tolerance(s.tcfg, s.top)
    assert np.isclose(float(rrg), float(rrw), rtol=1e-2)


def test_pcsi_and_lanczos_match(setup):
    s = setup
    ew = jsol.lanczos_eigs(s.jcfg, s.jop, s.jbc)
    eg = tsol.lanczos_eigs(s.tcfg, s.top, s.tbc)
    np.testing.assert_allclose(eg, ew, rtol=1e-9)
    assert 0.0 < eg[0] < eg[1]
    xw, mw, _ = jsol.pcsi(s.jcfg, s.jop, s.jbc, jnp.asarray(s.x0),
                          jnp.asarray(s.b), ew[0], ew[1])
    xg, mg, rrg = tsol.pcsi(s.tcfg, s.top, s.tbc, torch.as_tensor(s.x0),
                            torch.as_tensor(s.b), eg[0], eg[1])
    assert mg == int(mw) and 0 < mg < s.jcfg.solver.max_iterations
    assert scale_err(xg.numpy(), np.asarray(xw)) <= 1e-10


def test_converged_first_guess_takes_no_iteration(setup):
    s = setup
    xw, _, _ = jsol.chron_gear(s.jcfg, s.jop, s.jbc, jnp.asarray(s.x0),
                               jnp.asarray(s.b))
    x0 = torch.tensor(np.asarray(xw))
    _, m, rr = tsol.chron_gear(s.tcfg, s.top, s.tbc, x0,
                               torch.as_tensor(s.b))
    _, mj, _ = jsol.chron_gear(s.jcfg, s.jop, s.jbc, xw, jnp.asarray(s.b))
    assert m == int(mj) == 0 and float(rr) < tsol._tolerance(s.tcfg, s.top)


def test_solve_dispatch_and_float64_solve_under_float32(setup):
    s = setup
    b, x0 = torch.as_tensor(s.b), torch.as_tensor(s.x0)
    x64, m64, _ = tsol.solve(s.tcfg, s.top, s.tbc, x0, b)
    # float32 model, solve_dtype='float64': the 2-D solve runs in float64 on
    # the float32 operands and the solution comes back as float32
    cfg32 = s.tcfg.with_(dtype="float32",
                         solver=SolverConfigT(solve_dtype="float64"))
    op32 = s.top.to(torch.float32)
    x32, m32, rr32 = tsol.solve(cfg32, op32, s.tbc, x0.float(), b.float())
    assert x32.dtype == torch.float32 and rr32.dtype == torch.float64
    assert 0 < m32 < cfg32.solver.max_iterations
    assert scale_err(x32.numpy(), x64.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="Lanczos"):
        tsol.solve(s.tcfg.with_(solver=SolverConfigT(choice="pcsi")), s.top,
                   s.tbc, x0, b)
    # 'spai' without a stencil is the diagonal preconditioner, as in the
    # JAX package (tests/test_torch_files.py holds the stencils)
    spai = s.tcfg.with_(solver=SolverConfigT(preconditioner="spai"))
    r = torch.as_tensor(s.b)
    z = tsol.make_precond_apply(spai, s.top, s.tbc)(r)
    assert torch.equal(z, tsol.make_precond_apply(s.tcfg, s.top, s.tbc)(r))
    zj = jsol.make_precond_apply(
        s.jcfg.with_(solver=SolverConfig(preconditioner="spai")), s.jop,
        s.jbc)(jnp.asarray(s.b))
    assert scale_err(z.numpy(), np.asarray(zj)) <= 1e-15


def test_global_sum_matches_and_b4b_raises(setup):
    """The plain sum, and the b4b sum (carried since the decomposition
    over ranks): within 1e-13 of it, with the same bits for the values in
    another order."""
    x = torch.as_tensor(setup.x0)
    assert float(global_sum(x)) == pytest.approx(setup.x0.sum(), rel=1e-13)
    b4b = float(global_sum(x, b4b=True))
    assert b4b == pytest.approx(setup.x0.sum(), rel=1e-13)
    perm = torch.as_tensor(np.random.RandomState(3).permutation(
        setup.x0.ravel()).reshape(setup.x0.shape))
    assert float(global_sum(perm, b4b=True)) == b4b

