"""Roofline terms of the port on the NVIDIA H100 (PyTorch port of
``repro/roofline/analysis.py``).

The reference reads the compiled HLO of a jitted step: FLOPs of its
``dot`` / ``convolution`` ops and HBM bytes of its materializing ops, each
multiplied by its loops' trip counts. The port never makes HLO: it runs
eager PyTorch, one aten op after another, each reading its operands from
device memory and writing its result there. So its twin counts one call of
a torch function op by op, on the ``meta`` device (shapes only, no memory,
no time):

  * FLOPs with ``torch.utils.flop_counter.FlopCounterMode``, which counts
    matmuls, convolutions and attention as the reference counts ``dot`` /
    ``convolution`` only;
  * bytes with a dispatch mode that adds each aten op's operand and result
    bytes, views and metadata ops skipped: eager PyTorch's device-memory
    traffic, the counterpart of the reference's materializing-ops
    estimate (an elementwise op counts here, where XLA would fuse it);
  * the peak of live storage the call allocates (its temporaries: the
    arguments made before the call do not count).

Everything the call runs is counted once, as it runs: a loop over layers
or chunks, a microbatch, and under remat the backward's recompute, as the
reference's HLO counts it.

The three terms, as in the reference:
    compute_s    = FLOPs_per_chip / PEAK_FLOPS_BF16
    memory_s     = bytes_per_chip / HBM_BW
    collective_s = collective bytes_per_chip / (NVLINK_LINKS * NVLINK_LINK_BW)
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# ---- hardware constants (NVIDIA H100 SXM5 80GB, one card) ------------------
# NVIDIA's data sheet values for the card that PERF.md's runs name, dense
# rates at its 700 W limit; not measurements.
PEAK_FLOPS_BF16 = 989.4e12       # bf16 tensor-core products, dense
PEAK_FLOPS_FP32 = 67e12          # float32 outside the tensor cores
HBM_BW = 3.35e12                 # HBM3, bytes a second
NVLINK_LINK_BW = 25e9            # NVLink 4: bytes a second, one direction
NVLINK_LINKS = 18
# A compare is one 32-bit instruction; the float32 peak counts an FMA as
# two operations, so a card executes 33.5e12 compares a second.
COMPARES_PER_S = 33.5e12

# matmul-class ops (``OpStats.dots``)
_DOT_OPS = {"mm", "addmm", "bmm", "baddbmm", "convolution",
            "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_efficient_attention",
            "_scaled_dot_product_cudnn_attention"}
# ops that move no data; views are skipped by their schema's alias info
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.lift_fresh.default, torch.ops.aten.sym_size.int,
    torch.ops.aten.sym_stride.int, torch.ops.aten.sym_numel.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.is_same_size.default,
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpStats:
    """What ``count_ops`` counted: the fields of the reference's
    ``HLOStats`` that ``roofline_terms`` reads, and the port's own.

    ``flops`` and ``bytes_hbm`` are the call's (the caller divides them
    per chip); ``collective_bytes`` is filled by the caller from the
    placements (eager PyTorch makes no collective on the ``meta``
    device); ``dots`` counts matmul-class ops; ``peak_live_bytes`` is the
    peak of storage the call held at once; ``ops`` the aten ops it ran.
    The reference's ``while_loops`` has no twin: a Python loop leaves no
    trip count to recover, and each trip is counted as it runs."""
    flops: float = 0.0
    bytes_hbm: float = 0.0
    collective_bytes: float = 0.0
    dots: int = 0
    peak_live_bytes: int = 0
    ops: int = 0


class _Traffic(TorchDispatchMode):
    """Operand and result bytes of every aten op that moves data, and the
    peak of live storage allocated inside the mode: a storage counts from
    the op that makes it until the storage dies (torch keeps a storage's
    Python object while anything, a view or a tensor saved for backward,
    still holds it, so its finalizer fires when the memory would be
    freed)."""

    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats
        self.live = 0
        self.held: set = set()

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self.held.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        st = self.stats
        st.ops += 1
        if func._overloadpacket.__name__ in _DOT_OPS:
            st.dots += 1
        if func.is_view or func in _NO_TRAFFIC:
            return out
        st.bytes_hbm += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        outs = _tensors(out)
        st.bytes_hbm += sum(_nbytes(t) for t in outs)
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self.held:
                continue            # an in-place op's or an out= result
            n = s.nbytes()
            self.held.add(key)
            self.live += n
            weakref.finalize(s, self._free, key, n)
            st.peak_live_bytes = max(st.peak_live_bytes, self.live)
        return out


def count_ops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting its FLOPs, bytes and
    peak live storage: returns (its result, ``OpStats``). Call it on
    ``meta`` tensors to count a configuration of any size."""
    stats = OpStats()
    flops = FlopCounterMode(display=False)
    with flops, _Traffic(stats):
        out = fn(*args, **kwargs)
    stats.flops = float(flops.get_total_flops())
    return out, stats


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_chip: float
    useful_ratio: float

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(stats: OpStats, *, model_flops_total: float,
                   chips: int) -> Roofline:
    """stats are PER-CHIP. ``hlo_flops_per_chip`` keeps the reference's
    name: here it is the counted FLOPs a chip."""
    compute_s = stats.flops / PEAK_FLOPS_BF16
    memory_s = stats.bytes_hbm / HBM_BW
    coll_s = stats.collective_bytes / (NVLINK_LINKS * NVLINK_LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dom = max(terms, key=terms.get)
    mf_chip = model_flops_total / chips
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dom, model_flops=model_flops_total,
        hlo_flops_per_chip=stats.flops,
        useful_ratio=(mf_chip / stats.flops) if stats.flops else 0.0)


# ---------------------------------------------------------- model FLOPs
def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6*N*D for training, 2*N*D for inference; N = active params."""
    n_active = active_params(cfg)
    tokens = seq_len * global_batch
    if shape_kind == "train":
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    flops = 2.0 * n_active * global_batch
    if cfg.family not in ("ssm",):
        kv_heads, hd = cfg.n_kv_heads, cfg.hd
        attn_layers = sum(
            1 for i in range(cfg.n_layers)
            if cfg.layer_spec(i % cfg.period)["mixer"] == "attn")
        s_eff = min(seq_len, cfg.window) if cfg.window else seq_len
        flops += (4.0 * global_batch * attn_layers * cfg.n_heads * hd * s_eff)
    return flops


def active_params(cfg) -> float:
    """Parameter count with only topk (+shared) experts counted per token."""
    d, hd = cfg.d_model, cfg.hd
    total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    for i in range(cfg.n_layers):
        spec = cfg.layer_spec(i % cfg.period)
        if spec["mixer"] == "attn":
            total += d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        else:
            from ..models.ssm import dims as ssm_dims
            H, d_inner, conv_dim = ssm_dims(cfg)
            total += d * (2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + H)
            total += d_inner * d
        if spec["cross"]:
            total += d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        if spec["ffn"] == "dense":
            total += d * cfg.d_ff * (3 if cfg.mlp_act == "swiglu" else 2)
        elif spec["ffn"] == "moe":
            eff = cfg.topk + (1 if cfg.shared_expert else 0)
            total += eff * d * cfg.d_ff * 3 + d * cfg.n_experts
    if cfg.is_encoder_decoder:
        total += cfg.encoder_layers * (
            d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            + d * cfg.d_ff * 2)
    return float(total)
