#!/usr/bin/env python3
"""Shapes of the generated NitroGen kernel's bottoms, timed on one card.

    python3 experiments/nitrogen_bottoms.py [--variants NAME ...] [--out FILE]

Builds chip_smoke.py phase 21's indexes (NitroGen-binary and -css16 over
2^24 int32 keys, the vector bottom over 2^20 float32 keys in 256 blocks of
4,096, the 256-page tiered top over 32,768 keys) and, for each variant of
the kernel, rebuilds its source and stage array, holds it to the plain
network and bottom bit for bit at 2^20 queries, and times it at 2^20 and
4,096 queries beside ``torch.searchsorted`` over the same keys. A variant
is a (staging launch's threads a block, stage budget, source edit)
triple (VARIANTS):

  default   the kernel as the port builds it;
  nostage   no stage array: the first levels read the sample array (or
            the row) in device memory, never shared memory;
  nosample  no sample array: the levels below the staged ones probe the
            row itself, 4 bytes a probe, then its window;
  t512      staging launches of 512 threads a block (three blocks an SM
            with a full budget, less L1 left);
  s32k      a stage budget of 32 KB (one level fewer, more L1 left);
  kary      the vector bottom read by the two-step k-ary search the
            lower bound was weighed against: a lower bound over every
            128th key of the row, then the 128-key segment it selects,
            16 bytes a load (the other bottoms as in default).

Times are events around a CUDA graph of GRAPH_LAUNCHES back-to-back calls,
divided by their number (median of 7 replays, in turns: each variant
once, then again in reverse order); the profiler's device time a call
beside it (chip_smoke.device_ms). The result is the last line of the
output, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import IndexConfig, build_index  # noqa: E402
from repro_torch.core import nitrogen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import nitrogen_codegen as cg  # noqa: E402

GRAPH_LAUNCHES = 20
BATCHES = (1 << 20, 4096)
# the two-step k-ary read of a vector row, in place of the lower bound
_KARY = """NG_FN int ng_lower_bound(NG_KEY q, const NG_KEY* row,
                          const NG_KEY* staged, const NG_KEY* sample) {
  (void)staged;
  (void)sample;
  const int seg = 128, nseg = (NG_BLOCK_PAD_WIDTH + seg - 1) / seg;
  int lo = 0;
  for (int step = 1 << 20; step >= 1; step >>= 1)
    if (lo + step <= nseg &&
        ng_load(row + ((lo + step) * seg < NG_BLOCK_PAD_WIDTH
                           ? (lo + step) * seg : NG_BLOCK_PAD_WIDTH) - 1) < q)
      lo += step;
  if (lo == nseg) return NG_BLOCK_PAD_WIDTH;
  int c = 0;
  for (int j = lo * seg; j < (lo + 1) * seg && j < NG_BLOCK_PAD_WIDTH;
       j += NG_VEC)
    c += ng_below(ng_load_vec(row + j), q);
  return c + lo * seg;
}
"""
# name -> (staging threads a block, stage budget, source edit)
VARIANTS = {"default": (cg.STAGE_THREADS, cg.STAGE_BYTES, None),
            "nostage": (cg.STAGE_THREADS, 0, None),
            "nosample": (cg.STAGE_THREADS, cg.STAGE_BYTES, "nosample"),
            "t512": (512, cg.STAGE_BYTES, None),
            "s32k": (cg.STAGE_THREADS, 32_768, None),
            "kary": (cg.STAGE_THREADS, cg.STAGE_BYTES, "kary")}


def kary_source(source: str) -> str:
    """``source`` with the template inlined and its lower bound replaced
    by the k-ary read (vector rows of whole 16-byte pieces only)."""
    text = (_build.CSRC / cg.TEMPLATE).read_text()
    a = text.index("NG_FN int ng_lower_bound(")
    b = text.index("// |{k in block_pad[s, s + NG_CSS_LEAF_WIDTH)")
    text = text[:a] + _KARY + "\n" + text[b:]
    return source.replace(f'#include "{cg.TEMPLATE}"', text)


def variant(idx, name: str):
    """``idx`` with the kernel, stage and sample arrays of variant
    ``name`` (None where the variant does not apply)."""
    threads, budget, edit = VARIANTS[name]
    saved = cg.STAGE_THREADS, cg.STAGE_BYTES
    cg.STAGE_THREADS, cg.STAGE_BYTES = threads, budget
    try:
        levels, stage, sample = nitrogen._samples(
            idx.block_pad.cpu().numpy(), idx.bottom, idx.num_blocks,
            idx.block_pad_width)
        idx = dataclasses.replace(idx, stage_levels=levels)
        source = nitrogen.kernel_source(idx)
    finally:
        cg.STAGE_THREADS, cg.STAGE_BYTES = saved
    if edit == "kary":
        if idx.bottom != "vector" or "NG_LINEAR 1" in source:
            return None
        source = kary_source(source)
    elif edit == "nosample":
        if "#define NG_SAMPLE 1" not in source:
            return None
        source = source.replace("#define NG_SAMPLE 1", "#define NG_SAMPLE 0")
    top = cg.compile_top(source, idx.keys.dtype)
    dev = idx.keys.device
    return dataclasses.replace(idx, kernel=top,
                               stage=torch.from_numpy(stage).to(dev),
                               sample=torch.from_numpy(sample).to(dev))


def graph_ms(fn, x) -> float:
    """Events around a graph of GRAPH_LAUNCHES calls of ``fn(x)``, divided
    by their number: the median of 7 replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_LAUNCHES):
            fn(x)
    g.replay()
    times = []
    for _ in range(7):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_LAUNCHES)
    del g
    return float(np.median(times))


def indexes(dev) -> dict:
    """Phase 21's indexes: name -> (index, queries, clip)."""
    rng = np.random.default_rng(21)
    keys = np.unique(rng.integers(cs.I32.min + 1, cs.I32.max - 1,
                                  int(cs.N_KEYS * 1.05)).astype(np.int32))
    keys = np.sort(rng.permutation(keys)[:cs.N_KEYS])
    q = cs.mixed_queries(rng, keys, cs.N_QUERIES)
    out = {}
    for name, bottom in (("ng_l3_binary_2^24", "binary"),
                         ("ng_l3_css16_2^24", "css")):
        out[name] = (build_index(keys, config=IndexConfig(
            kind="nitrogen", levels=3, compiled_node_width=3, bottom=bottom,
            node_width=16)).impl, q, None)
    fk, fq = cs.ng_float_keys(rng, cs.NG_FLOAT_KEYS)
    out["ng_l4_vector_f32_2^20"] = (build_index(fk, config=IndexConfig(
        kind="nitrogen", levels=4, compiled_node_width=3,
        bottom="vector")).impl, fq, None)
    tk = rng.integers(cs.I32.min + 1, cs.I32.max - 1, cs.NG_TIERED_KEYS
                      ).astype(np.int32)
    tidx = build_index(tk, config=IndexConfig(kind="tiered"))
    assert tidx.impl.top_kind == "nitrogen" and tidx.impl.num_pages == 256
    out["tiered_top_32768"] = (tidx.impl.top, cs.mixed_queries(
        rng, np.sort(tk), cs.N_QUERIES), 255)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nitrogen_bottoms: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"card": card, "graph_launches": GRAPH_LAUNCHES, "indexes": {}}
    for name, (idx, q, clip) in indexes(dev).items():
        qd = torch.from_numpy(q).to(dev)
        want = nitrogen.search_plain(idx, qd, clip)
        row = res["indexes"][name] = {"variants": {}, "library": {}}
        runs, sources = {}, {}
        for v in args.variants:
            vidx = variant(idx, v)
            if vidx is None:
                continue
            if vidx.kernel.source in sources:        # the same kernel
                row["variants"][v] = {"same_as": sources[vidx.kernel.source]}
                continue
            sources[vidx.kernel.source] = v
            got = nitrogen.search(vidx, qd, clip=clip)
            assert torch.equal(got, want), f"{name} / {v} != plain"
            top = vidx.kernel
            row["variants"][v] = {
                "threads": top.threads, "shared": top.shared,
                "stage_levels": cg.defined(top.source, "NG_STAGE_LEVELS", 0),
                "sample": cg.defined(top.source, "NG_SAMPLE", 0),
                "sample_bytes": vidx.sample.numel() * vidx.sample.element_size(),
                "launch": {str(n): top.launch(dev.index or 0, n)
                           for n in BATCHES},
                "resources": top.resources, "compile_s": top.compile_s}
            runs[v] = vidx
        for n in BATCHES:
            x = qd[:n].contiguous()
            ks = idx.keys
            b = idx.network(x).cpu().numpy()
            nbytes, compares, _ = cs.ng_work(idx, q[:n], b)
            row[str(n)] = {"bound_ms": cs.bound(nbytes, compares),
                           "searchsorted_graph_ms": graph_ms(
                               lambda y: torch.searchsorted(ks, y), x)}
            order = list(runs) + list(reversed(runs))
            times: dict = {v: [] for v in runs}
            for v in order:
                vidx = runs[v]
                times[v].append(graph_ms(
                    lambda y: nitrogen.search(vidx, y, clip=clip), x))
            for v, vidx in runs.items():
                row["variants"][v][str(n)] = {
                    "graph_ms": times[v],
                    "device_ms": cs.device_ms(
                        lambda: nitrogen.search(vidx, x, clip=clip),
                        reps=5, tries=2)}
        print(name, json.dumps(row), flush=True)
        del runs
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
