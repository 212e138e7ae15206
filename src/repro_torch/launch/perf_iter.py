"""Perf-iteration tool (PyTorch port of ``repro/launch/perf_iter.py``):
re-counts one (arch x shape) cell under a named variant of knobs with
``dryrun.lower_cell`` and appends its record, so every hypothesis ->
change -> measure step is a one-line invocation:

    PYTHONPATH=src python -m repro_torch.launch.perf_iter \\
        --arch jamba-v0.1-52b --shape train_4k \\
        --name ssd128+sp --set ssd_chunk=128 seq_axis=model
"""
from __future__ import annotations

import argparse
import json
import os


def parse_kv(pairs):
    out = {}
    for p in pairs:
        k, val = p.split("=", 1)
        if val in ("true", "false"):
            out[k] = val == "true"
        elif val.isdigit():
            out[k] = int(val)
        elif "," in val:
            out[k] = tuple(int(x) for x in val.split(","))
        else:
            out[k] = val
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--name", required=True, help="variant label")
    ap.add_argument("--set", nargs="*", default=[], help="knob=value ...")
    ap.add_argument("--out", default="experiments/perf_iters.jsonl")
    args = ap.parse_args(argv)

    from .dryrun import lower_cell
    variant = parse_kv(args.set)
    rec = lower_cell(args.arch, args.shape, args.mesh == "multi",
                     variant=variant)
    rec["variant_name"] = args.name
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    r, m = rec["roofline"], rec["memory"]
    print(f"{args.name}: dom={r['dominant']} compute={r['compute_s']:.3f}s "
          f"memory={r['memory_s']:.3f}s collective={r['collective_s']:.3f}s "
          f"useful={r['useful_ratio']:.3f} "
          f"peak={m['peak_bytes_per_device']/2**30:.1f}GiB")


if __name__ == "__main__":
    main()
