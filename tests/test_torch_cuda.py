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
from repro_torch.kernels import page_scan as ps
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


def scan_lanes(cuda, dtype, leaf_width, rng):
    """Bound pairs bucketed by page as the span pipeline buckets them:
    (index, lo_b, hi_b, step_pages, steps_used, value pages)."""
    keys = rng.normal(size=leaf_width * 300) * 1e6
    idx = tiered.build(keys.astype(dtype), leaf_width=leaf_width, device=cuda)
    lo = torch.from_numpy((rng.normal(size=5000) * 1e6).astype(dtype)).to(cuda)
    hi = lo + torch.from_numpy(
        (rng.normal(size=5000) * 1e4).astype(dtype)).to(cuda)
    g_cap = schedule.ladder_grid(lo.shape[0], idx.tile, idx.num_pages)
    plan = schedule.edge_scan_plan(idx.page_of(lo), idx.tile, g_cap,
                                   idx.num_pages)
    lanes = [torch.zeros(g_cap * idx.tile, dtype=lo.dtype, device=cuda)
             .scatter_(0, plan.dest.long(), x).view(g_cap, idx.tile)
             for x in (lo, hi)]
    vals = rng.integers(-2**31, 2**31 - 1, idx.pages.shape) \
        if dtype == np.int32 else rng.normal(size=idx.pages.shape)
    vpages = torch.from_numpy(vals.astype(dtype)).to(cuda)
    vpages.view(-1)[::13] = -7
    return idx, *lanes, plan.step_pages, plan.steps_used, vpages


def assert_kernel_matches(got, want, used, sum_at):
    """Counts, int32 sums, min and max bit for bit; float sums to rtol 1e-4
    (the kernel adds in slot order, the plain version in torch's)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if i == sum_at and g.dtype == torch.float32:
            torch.testing.assert_close(g[:used], w[:used], rtol=1e-4,
                                       atol=1e-4)
        else:
            assert torch.equal(g[:used], w[:used])


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("mode", ["count", "sum", "full"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("leaf_width", [100, 2000])       # lw_pad 128, 2048
def test_page_scan_kernel_matches_plain(cuda, dtype, leaf_width, mode, mask):
    rng = np.random.default_rng(leaf_width + 7)
    idx, lo_b, hi_b, sp, used_t, vpages = scan_lanes(cuda, dtype, leaf_width,
                                                      rng)
    used = int(used_t)
    assert used < sp.shape[0]
    got = ps.page_scan_bucketed(lo_b, hi_b, sp, idx.pages, vpages, mode=mode,
                                mask_value=mask, steps_used=used_t)
    want = ps.page_scan_plain(lo_b, hi_b, sp, idx.pages,
                              None if mode == "count" else vpages, mode=mode,
                              mask_value=None if mode == "count" else mask)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert_kernel_matches(got, want, used, sum_at=2)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, -7])
@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_page_prefix_kernel_matches_plain(cuda, dtype, with_values, mask):
    rng = np.random.default_rng(11)
    idx, e_b, _, sp, used_t, vpages = scan_lanes(cuda, dtype, 2000, rng)
    used = int(used_t)
    vp = vpages if with_values else None
    got = ps.page_prefix_bucketed(e_b, sp, idx.pages, vp, mask_value=mask,
                                  steps_used=used_t)
    want = ps.page_prefix_plain(e_b, sp, idx.pages, vp,
                                mask_value=mask if with_values else None)
    torch.cuda.synchronize()
    if not with_values:
        got, want = (got,), (want,)
    assert_kernel_matches(got, want, used, sum_at=1)


def cdf_rows(rng, B: int, V: int):
    """(cdf, u) with rows from softmax + sort + cumsum of seeded logits,
    flat runs, +inf tails, and u at 0, 1e-6, on a cdf entry, above
    cdf[-1] and inside a flat run."""
    x = rng.normal(size=(B, V)) * 3
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    cdf = np.cumsum(-np.sort(-p, axis=-1), -1).astype(np.float32)
    cdf[1::4, V // 4:V // 2] = cdf[1::4, V // 4:V // 4 + 1]
    u = rng.uniform(0, 1, B).astype(np.float32)
    u[0::6], u[1::6] = 0.0, 1e-6
    u[2::6] = cdf[2::6, V // 3]
    u[3::6] = cdf[3::6, -1] + 0.25
    u[5::6] = cdf[5::6, V // 4]                  # row 5 is flat (5 % 4 == 1)
    cdf[4::5, 3 * V // 4:] = np.inf
    return cdf, u


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(1, 100), (3, 1000), (8, 2048),
                                 (64, 152_064), (256, 1000)])
def test_cdf_kernel_matches_plain(cuda, B, V):
    from repro_torch.kernels import cdf_search as cs
    cdf, u = cdf_rows(np.random.default_rng(B + V), B, V)
    cd, ud = torch.from_numpy(cdf).to(cuda), torch.from_numpy(u).to(cuda)
    got = cs.cdf_search(cd, ud)
    want = cs.invert_cdf(cd, ud)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    ref = np.array([np.searchsorted(cdf[b], u[b], "left") for b in range(B)])
    np.testing.assert_array_equal(got.cpu().numpy(), np.minimum(ref, V - 1))
    # an unaligned view takes the scalar path
    odd = torch.from_numpy(np.ascontiguousarray(cdf[:, 1:])).to(cuda)
    assert torch.equal(cs.cdf_search(odd, ud), cs.invert_cdf(odd, ud))
    assert cs.cdf_search(cd[:0], ud[:0]).shape == (0,)


@pytest.mark.cuda
def test_sampled_generate_on_the_card(cuda, monkeypatch):
    """A reduced qwen3-0.6b served on the card, sampled: one CDF kernel
    launch per decode step, page-search launches for the store probes, and
    every token inside its row's top-p nucleus."""
    from repro_torch.configs import get_config
    from repro_torch.core import IndexConfig
    from repro_torch.kernels import cdf_search as cs
    from repro_torch.models import transformer as T
    from repro_torch.serve import SamplerConfig, ServeEngine
    from repro_torch.serve import engine as engine_mod
    cfg = get_config("qwen3-0.6b").reduced()
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    scfg = SamplerConfig(temperature=0.8, top_p=0.9)
    eng = ServeEngine(cfg, params, max_len=64, page_size=8,
                      index_config=IndexConfig(kind="tiered", mutable=False),
                      sampler=scfg, decode_batching=False)
    seen = []
    real = engine_mod.sample

    def record(logits, cfg_, *, generator=None):
        seen.append(logits.clone())
        tok = real(logits, cfg_, generator=generator)
        seen.append(tok)
        return tok

    monkeypatch.setattr(engine_mod, "sample", record)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 7)])
               for _ in range(2)]
    cs.cdf_search.launches = pk.page_search_bucketed.launches = 0
    for _ in range(2):
        out = eng.generate(prompts, 4)
    assert cs.cdf_search.launches == 8
    assert pk.page_search_bucketed.launches > 0
    assert out.shape == (2, 4) and out.device.type == cuda.type
    assert eng.stats.reused_tokens > 0
    for logits, tok in zip(seen[::2], seen[1::2]):
        p = torch.softmax(logits.double() / 0.8, -1)
        pt = p.gather(1, tok[:, None].long())
        above = torch.where(p > pt, p, 0.0).sum(-1)
        assert bool((above < 0.9 + 1e-4).all())
