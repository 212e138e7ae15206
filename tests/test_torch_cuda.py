"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip on a machine without an NVIDIA card (a CUDA
kernel has no CPU mode). This file imports neither jax nor the reference
package, so it runs where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kary as kary_core
from repro_torch.engine import schedule, tiered
from repro_torch.kernels import kary_search as kk
from repro_torch.kernels import ops
from repro_torch.kernels import page_search as pk

I32 = np.iinfo(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("leaf_width", [100, 2000])       # lw_pad 128, 2048
def test_page_kernel_matches_plain(cuda, dtype, leaf_width):
    rng = np.random.default_rng(leaf_width)
    keys = rng.normal(size=leaf_width * 300) * 1e6
    q = rng.normal(size=5000) * 1e6
    idx = tiered.build(keys.astype(dtype), leaf_width=leaf_width, device=cuda)
    qd = torch.from_numpy(q.astype(dtype)).to(cuda)
    g_cap = schedule.ladder_grid(qd.shape[0], idx.tile, idx.num_pages)
    plan = schedule.device_plan(idx.page_of(qd), idx.tile, g_cap,
                                idx.num_pages)
    qb =torch.zeros(g_cap * idx.tile, dtype=qd.dtype, device=cuda) \
        .scatter_(0, plan.dest.long(), qd).view(g_cap, idx.tile)
    used = int(plan.steps_used)
    assert used < g_cap
    got = pk.page_search_bucketed(qb, plan.step_pages, idx.pages,
                                  stride=idx.lw_pad,
                                  steps_used=plan.steps_used)
    want = pk.page_search_plain(qb, plan.step_pages, idx.pages,
                                stride=idx.lw_pad)
    torch.cuda.synchronize()
    assert torch.equal(got[:used], want[:used])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_kary_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(4)
    if dtype == np.int32:
        keys = np.concatenate([I32.min + np.arange(4096),
                               I32.max - 1 - np.arange(4096)])
        q = rng.integers(I32.min, I32.max, 20000, dtype=np.int64)
    else:
        keys = rng.normal(size=8192) * 10.0 ** rng.integers(-30, 30, 8192)
        q = rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000)
    keys = np.unique(keys.astype(dtype))
    idx = kary_core.build(keys, node_width=127, device=cuda)
    flat, offsets = kk.flatten_levels(ops.kary_levels(idx, 128))
    qd = torch.from_numpy(np.concatenate([q, keys]).astype(dtype)).to(cuda)
    got = kk.kary_search_levels(qd, flat, offsets, fanout=128, wpad=128)
    want = kk.kary_search_plain(qd, flat, offsets, fanout=128, wpad=128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kk.kary_search_levels(qd[:0], flat, offsets, fanout=128,
                                 wpad=128).shape == (0,)
