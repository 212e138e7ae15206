#!/usr/bin/env python3
"""What many repacks of a small mutable store cost, on the card.

    python3 experiments/nitrogen_repacks.py --root DIR [--repacks N] [--out F]

Imports the port from DIR/src, so that two commits run the same rounds in
one call (unpack the earlier one under a git-ignored directory with
``git archive COMMIT | tar -x -C build/parent``). A mutable tiered store
of 20,000 int32 keys (leaf width 128, about 209 pages: a NitroGen top,
compiled into a generated kernel) takes N rounds. Each round inserts 64
new keys into one page and deletes 64 live keys of another, so the page
overflows, the flush repacks every page, the top is derived again and
compiles a new kernel, while the key count, and with it the page count,
stays where it was. Every 10 rounds it records the process's resident
host memory (VmRSS), the card's used memory (``cudaMemGetInfo``: module
code included) beside what PyTorch's allocator holds, the generated
kernels alive in the process and the generated cubins on disk, and
their change a repack from round 50 on; every 25 rounds it looks up
every live key and 4,096 misses against numpy. Prints one JSON line with the card's name and power limit (and writes it to
FILE).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

KEYS = 20_000
MOVED = 64                      # keys inserted into one page a round


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return -1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to run")
    ap.add_argument("--repacks", type=int, default=200)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("nitrogen_repacks: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import IndexConfig, build_index
    from repro_torch.kernels import _build
    from repro_torch.kernels import nitrogen_codegen as cg
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(27)

    def sample(r: int, repack_ms: list) -> dict:
        free, total = torch.cuda.mem_get_info()
        return {"round": r, "rss_bytes": rss_bytes(),
                "device_used_bytes": total - free,
                "torch_reserved_bytes": torch.cuda.memory_reserved(),
                "kernels_alive": cg.loaded(),
                "cubins_on_disk": len(list(_build.BUILD_DIR.glob(
                    f"{cg.STEM}-*.cubin"))),
                "repack_ms_median_last_10": float(np.median(
                    repack_ms[-10:])) if repack_ms else None}

    keys = np.unique(rng.integers(0, 10**8, KEYS * 2).astype(np.int32))
    keys = rng.permutation(keys)[:KEYS]
    t0 = time.perf_counter()
    store = build_index(keys, keys, IndexConfig(
        kind="tiered", mutable=True, leaf_width=128, delta_capacity=1024))
    torch.cuda.synchronize()
    out = {"root": args.root, "card": card, "keys": KEYS,
           "build_s": time.perf_counter() - t0,
           "pages": store.base.num_pages, "samples": []}
    live = np.sort(keys)
    repack_ms = []
    out["samples"].append(sample(0, repack_ms))
    for r in range(1, args.repacks + 1):
        b = store.base
        assert b.top_kind == "nitrogen", "the store's top left NitroGen"
        p = 1 + (37 * r) % (b.num_pages - 2)
        lo, hi = int(b.seps[p - 1]) + 1, int(b.seps[p]) + 1
        new = np.setdiff1d(rng.integers(lo, hi, MOVED * 4), live)
        new = new[:MOVED].astype(np.int32)
        i = (np.searchsorted(live, lo) + live.size // 2) % (live.size - MOVED)
        gone = live[i: i + MOVED]             # half the key space away
        splits = store.stats["splits"]
        store.insert(new, new)
        store.delete(gone)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.flush()
        torch.cuda.synchronize()
        repack_ms.append((time.perf_counter() - t0) * 1e3)
        assert store.stats["splits"] > splits, f"round {r}: no repack"
        live = np.setdiff1d(np.union1d(live, new), gone)
        if r % 25 == 0 or r == args.repacks:
            q = np.concatenate([live, rng.integers(0, 10**8, 4096)]
                               ).astype(np.int32)
            res = store.lookup(torch.from_numpy(q).to(dev))
            found = np.isin(q, live)
            assert np.array_equal(res.found.cpu().numpy(), found) and \
                np.array_equal(res.values.cpu().numpy()[found], q[found]), \
                f"round {r}: lookups != numpy"
        if r % 10 == 0 or r == args.repacks:
            out["samples"].append(sample(r, repack_ms))
    out["repacks"] = args.repacks
    out["pages_end"] = store.base.num_pages
    out["repack_ms"] = repack_ms
    out["repack_ms_median"] = float(np.median(repack_ms))
    # from round 50: the first lookups (round 25) load PyTorch's own
    # kernels, about 100 MB of the card's memory once
    first = next(x for x in out["samples"] if x["round"] >= 50) \
        if args.repacks >= 60 else out["samples"][1]
    last = out["samples"][-1]
    span = last["round"] - first["round"]
    out["per_repack_from_round_50"] = {
        k: (last[k] - first[k]) / span for k in
        ("rss_bytes", "device_used_bytes", "kernels_alive",
         "cubins_on_disk")} if span else None
    store.close()
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
