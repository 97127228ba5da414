"""The launch planners of the two kernels that stage in shared memory
(thomas, GM chain): plain Python that chooses the block shape and the dynamic
shared memory for each (value size, right-hand sides or tracers, levels),
and refuses what the kernels do not take, before anything is built. Runs on
the CPU; the kernels themselves are held against their plain versions on the
card by chip_smoke.py, which also holds the planners' shared-memory counts
against the library's."""

import pytest
import torch

from pop2_tpu_torch import _cuda_build as cb
from pop2_tpu_torch import gm_chain_cuda, tridiag_cuda
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
@pytest.mark.parametrize("value_bytes,nr,km", [(4, 1, 1), (8, 3, 64)])
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
    ((8, 4, 60), "at most 3"),
    ((8, 0, 60), "at most 3"),
])
def test_thomas_plan_refuses(args, match):
    with pytest.raises(NotImplementedError, match=match):
        tridiag_cuda.launch_plan(*args)


# the smallest tile, and the largest the kernel takes (16 tracers in float64)
@pytest.mark.parametrize("value_bytes,nt,rows", [(4, 1, 8), (8, 16, 6)])
def test_chain_plan_fits_the_tile(value_bytes, nt, rows):
    (cols, got_rows), smem = gm_chain_cuda.launch_plan(value_bytes, nt)
    assert (cols, got_rows) == (gm_chain_cuda.TILE_COLS, rows)
    assert smem == gm_chain_cuda.smem_values(nt) * cols * rows * value_bytes
    assert smem <= cb.SMEM_PER_BLOCK


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
                                         (4, 8, "at most 3")])
def test_thomas_wrapper_refuses_before_building(no_build, nr, km, match):
    ny, nx = 3, 4
    rhs = torch.zeros(nr, km, ny, nx).as_subclass(OnCard)
    with pytest.raises(NotImplementedError, match=match):
        tridiag_cuda.thomas(torch.ones(km), torch.ones(ny, nx),
                            torch.full((ny, nx), km, dtype=torch.int32),
                            torch.zeros(km, ny, nx), rhs)


def test_chain_wrapper_refuses_before_building(no_build):
    cfg = get_config("mini", hmix_tracer="gm", gm_transition_layer=True,
                     gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
                     lsubmeso=False)
    grid = build_grid(cfg, "cpu")
    f3 = (cfg.km, cfg.ny, cfg.nx)
    tmix = torch.zeros((17,) + f3).as_subclass(OnCard)
    with pytest.raises(NotImplementedError, match="16 tracers"):
        gm_chain_cuda.chain(cfg, grid, None, tmix, None, None, None, None)
