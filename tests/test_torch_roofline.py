"""The port's roofline module and input shapes against the reference's.

  * ``SHAPES`` and ``shape_applicable`` equal the reference's for every
    arch x shape;
  * ``active_params`` and ``model_flops`` equal the reference's for every
    arch x shape kind (the same arithmetic: equal as floats);
  * the reference's ``test_model_flops_formulas`` and
    ``test_roofline_terms_dominance``, on the port, at the H100's
    constants;
  * ``count_ops`` on a known function (FLOPs, bytes, peak live storage)
    and on one step of reduced qwen3 on the ``meta`` device against
    ``model_flops``: a decode step within 1% of it, a train step between
    1.1 and 1.3 times it, and with remat by group (the forward runs twice)
    between 1.3 and 1.6 times it.

The reference's three HLO-parsing tests (``test_canned_module_flops_and_
trips``, ``test_backend_config_trip_count_preferred``,
``test_shape_bytes_tuple_with_comments``) and ``tests/test_launchers.py::
test_traffic_breakdown_tool`` have no twin: they read XLA HLO text, which
the port never makes. The port counts aten ops as they run instead
(``count_ops``), held here to shapes and to ``model_flops``.
"""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_shape_applicable
from repro.roofline import analysis as ref_RA

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.core.util import tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as RA
from repro_torch.train import make_loss_fn

LM_ARCHS = [a for a in ARCH_IDS if a != "nitrogen-db"]


def test_shapes_equal_reference():
    assert SHAPES == REF_SHAPES
    for arch in ARCH_IDS:
        for shape in list(SHAPES) + ["unknown"]:
            assert shape_applicable(get_config(arch), shape) == \
                ref_shape_applicable(ref_get_config(arch), shape), \
                (arch, shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_active_params_and_model_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert RA.active_params(cfg) == ref_RA.active_params(rcfg)
    for reduced in (False, True):
        c, rc = (cfg.reduced(), rcfg.reduced()) if reduced else (cfg, rcfg)
        for sh in SHAPES.values():
            for kind in ("train", "prefill", "decode"):
                args = (kind, sh["seq_len"], sh["global_batch"])
                assert RA.model_flops(c, *args) == \
                    ref_RA.model_flops(rc, *args), (arch, reduced, args)


def test_model_flops_formulas():
    cfg = get_config("mixtral-8x7b")
    n_act = RA.active_params(cfg)
    # mixtral active ~12.9B (2 of 8 experts + attn + embeddings)
    assert 11e9 < n_act < 15e9
    train = RA.model_flops(cfg, "train", 4096, 256)
    assert abs(train - 6 * n_act * 4096 * 256) / train < 1e-9
    dec = RA.model_flops(cfg, "decode", 32768, 128)
    assert dec > 2 * n_act * 128          # adds attention-over-cache term

    dense = get_config("qwen3-0.6b")
    nd = RA.active_params(dense)
    assert 0.4e9 < nd < 1.1e9


def test_roofline_terms_dominance():
    """The reference's case at the H100's constants: one second of peak
    bf16 FLOPs, two seconds of HBM bytes."""
    assert RA.PEAK_FLOPS_BF16 == 989.4e12 and RA.HBM_BW == 3.35e12
    assert RA.NVLINK_LINKS * RA.NVLINK_LINK_BW == 450e9
    st = RA.OpStats(flops=RA.PEAK_FLOPS_BF16, bytes_hbm=RA.HBM_BW * 2,
                    collective_bytes=1)
    r = RA.roofline_terms(st, model_flops_total=RA.PEAK_FLOPS_BF16 * 256,
                          chips=256)
    assert r.dominant == "memory"
    assert abs(r.compute_s - 1.0) < 1e-6
    assert abs(r.memory_s - 2.0) < 1e-6
    assert abs(r.useful_ratio - 1.0) < 1e-6
    st = RA.OpStats(flops=1.0, bytes_hbm=1.0,
                    collective_bytes=RA.NVLINK_LINKS * RA.NVLINK_LINK_BW * 3)
    r = RA.roofline_terms(st, model_flops_total=0.0, chips=1)
    assert r.dominant == "collective" and abs(r.collective_s - 3.0) < 1e-9


def test_count_ops_on_a_known_function():
    """x @ x on [64, 64] float32: 2 * 64^3 FLOPs, two operands and a
    result of 16 KB; exp reads and writes 16 KB, the sum reads 16 KB and
    writes 4 bytes. x was made before the count; at the peak the product,
    the exp's result and the sum's scalar are live, and the exp's result
    dies after it. The transpose is a view: no bytes."""
    x = torch.empty(64, 64, device="meta")

    def fn(x):
        y = x @ x
        z = torch.exp(y).sum()          # exp's result freed after the sum
        return y.t(), z
    (yt, z), st = RA.count_ops(fn, x)
    kb = 64 * 64 * 4
    assert st.flops == 2 * 64 ** 3 and st.dots == 1
    assert st.bytes_hbm == 3 * kb + 2 * kb + kb + 4
    assert st.peak_live_bytes == 2 * kb + 4
    assert yt.shape == (64, 64) and st.ops == 4
    assert st.collective_bytes == 0


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-0.6b").reduced()
    return cfg, T.init_params(cfg, None, "meta")


def test_counted_decode_flops_match_model_flops(qwen):
    """One decode step of 4 rows over a 64-token cache: the matmuls of
    the active params and the attention over the cache, as model_flops
    counts them (measured ratio 1.000)."""
    cfg, params = qwen
    B, S = 4, 64
    cache = T.init_cache(cfg, B, S, torch.bfloat16, device="meta")
    with torch.no_grad():
        (logits, _), st = RA.count_ops(
            T.decode_step, cfg, params,
            torch.zeros(B, dtype=torch.int32, device="meta"), cache)
    assert logits.shape == (B, cfg.padded_vocab)
    ratio = st.flops / RA.model_flops(cfg, "decode", S, B)
    assert 0.99 < ratio < 1.01, ratio
    assert st.bytes_hbm > 0 and st.peak_live_bytes > 0


@pytest.mark.parametrize("remat,band", [(False, (1.1, 1.3)),
                                        (True, (1.3, 1.6))])
def test_counted_train_flops_against_model_flops(qwen, remat, band):
    """The forward and backward of reduced qwen3 at 4 x 64 tokens against
    6 N D: the attention's products and the CE chunk's recomputed logits
    come on top (measured 1.21 without remat); remat by group runs the
    blocks' forward again in the backward, 8 N D in place of 6 (measured
    1.43). The backward's recompute is counted as it runs."""
    cfg, params = qwen
    B, S = 4, 64
    tok = torch.zeros(B, S, dtype=torch.int32, device="meta")
    loss_fn = make_loss_fn(cfg, remat=remat, attn_chunks=(16, 16),
                           ce_chunk=32)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    work = tree_map(lambda _: next(it), params)

    def fwd_bwd():
        loss, _ = loss_fn(work, tok, tok)
        return torch.autograd.grad(loss, leaves, allow_unused=True)
    grads, st = RA.count_ops(fwd_bwd)
    assert sum(g is not None for g in grads) == len(leaves)
    ratio = st.flops / RA.model_flops(cfg, "train", S, B)
    assert band[0] < ratio < band[1], ratio
    assert np.isfinite(st.bytes_hbm) and st.dots > 0
