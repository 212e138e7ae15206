"""Time shapes of the CDF-inversion kernel (src/repro_torch/csrc/cdf_search.cu)
on one CUDA card: block size and loads in flight a thread, at clusters of
8 and 16 blocks a row, beside the design it replaced and torch.searchsorted.

    python3 experiments/cdf_variants.py [--earlier SRC] [--out results.json]

Each variant is the source with its kThreads / kLoads / kCluster constants
replaced (and, in some, one block an SM, or a part of the work taken out:
see SHAPES and PARTS), built with the port's nvcc flags into
build/variants/; each also reports how many of its clusters fit the card
at once. The ablations in PARTS find their edit points by the kernel's
code text, so an edit to those lines of the kernel makes this script
raise (it names the text it did not find): it measures the design as it
stands and is updated with it. --earlier names the replaced design's
source (`git show 2ff2086:src/repro_torch/csrc/cdf_search.cu`). Rows are softmax-sorted CDFs at V = 152,064 made on the card from a seed;
every variant is held to the plain version before it is timed. Times are
the profiler's device time a call (chip_smoke.device_ms) and the median
CUDA-event time (chip_smoke.cuda_ms), taken in turns (each variant once,
then again in reverse order). A one-entry fill is timed too: the device
time of the smallest kernel, the floor under every row.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cdf_search as cs  # noqa: E402

# (kThreads, kLoads, spread), each at every cluster size in CLUSTERS (past
# 8 the launch allows a non-portable size): with spread, every launch asks
# for 120 KB of dynamic shared memory (unused), so one block fits an SM
# and a cluster's blocks land on as many SMs
SHAPES = ((128, 8, False), (256, 8, False), (512, 8, False), (256, 8, True),
          (512, 8, True))
CLUSTERS = (8, 16)
SPREAD_BYTES = 120 * 1024
# Timing-only variants of the 256 x 8 shape at clusters of 8, each with a
# part of the design taken out, to see what that part costs (their
# results, but for "nobound"'s, are wrong on purpose; none is checked):
# "nosync" has no cluster barrier and no distributed shared memory (each
# block stores its own count); "noload" reads no cdf entry (the barrier
# and the store stay); "nocluster" is "nosync" launched as plain blocks,
# no cluster at all; "nobound" drops the kernel's minimum of resident
# threads, so ptxas picks its register count freely.
_NOSYNC = (
    (re.compile(r"\n *cluster\.sync\(\);[^\n]*"), ""),
    ("*cluster.map_shared_rank(&block_counts[buf][rank], 0) = cnt;",
     "out[b] = cnt;"),
    ("if (rank == 0 && warp == 0) {", "if (false) {"))
PARTS = {
    "nosync": _NOSYNC,
    "noload": ((re.compile(r"int cnt = vec \? count_slice.*?;", re.S),
                "int cnt = uv < 0.f;"),),
    "nocluster": _NOSYNC + (
        ("static_cast<int>(cluster.block_rank())",
         "static_cast<int>(blockIdx.x)"),
        ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")),
    "nobound": (("__launch_bounds__(kThreads, 1536 / kThreads)",
                 "__launch_bounds__(kThreads)"),),
}
# appended to each variant: how many clusters of `cluster` blocks fit the
# card at once, as the occupancy API reports it
MAX_CLUSTERS = """
extern "C" int cdf_search_max_clusters(int cluster, int smem, int* n) {
  if (cluster > 8)
    cudaFuncSetAttribute(cdf_search_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (smem)
    cudaFuncSetAttribute(cdf_search_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(n, cdf_search_kernel, &cfg));
}
"""
BATCHES = (1, 8, 64, 256)
V = 152_064


def variant_text(src: str, threads: int, loads: int, cluster: int,
                 spread: bool, part: str | None) -> str:
    text = src
    for const, value in (("kThreads", threads), ("kLoads", loads),
                         ("kCluster", cluster)):
        text, hits = re.subn(rf"{const} = \d+;", f"{const} = {value};", text)
        if hits != 1:
            raise RuntimeError(f"the source has no one {const} constant")
    text = text.replace("}  // namespace", MAX_CLUSTERS.replace(
        'extern "C" ', "") + "}  // namespace", 1) + \
        'extern "C" int cdf_search_max_clusters_c(int c, int s, int* n) ' \
        "{ return cdf_search_max_clusters(c, s, n); }\n"
    launch = "  const cudaError_t err = cudaLaunchKernelEx("
    if cluster > 8:
        if launch not in text:
            raise RuntimeError(f"the source has no {launch!r}")
        text = text.replace(launch, (
            "  cudaFuncSetAttribute(cdf_search_kernel, "
            "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n" + launch))
    if spread:
        text = text.replace(
            "cfg.dynamicSmemBytes = 0;",
            f"cfg.dynamicSmemBytes = {SPREAD_BYTES}; cudaFuncSetAttribute("
            "cdf_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize"
            f", {SPREAD_BYTES});")
    for old, new in PARTS.get(part, ()):
        hit = old.search(text) if isinstance(old, re.Pattern) else old in text
        if not hit:
            raise RuntimeError(f"variant {part}: the source has no {old!r}")
        text = old.sub(new, text) if isinstance(old, re.Pattern) \
            else text.replace(old, new)
    return text


def build_variants() -> dict:
    src = (_build.CSRC / "cdf_search.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = {f"t{t}_l{n}" + ("_spread" if sp else "") + f"_c{k}":
             (t, n, k, sp, None) for t, n, sp in SHAPES for k in CLUSTERS}
    specs.update({f"t256_l8_{part}_c8": (256, 8, 8, False, part)
                  for part in PARTS})
    procs = {}
    for name, spec in specs.items():
        path = out_dir / f"{name}.cu"
        path.write_text(variant_text(src, *spec))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(lib), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).cdf_search_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", log)
        mc = ctypes.CDLL(str(lib)).cdf_search_max_clusters_c
        mc.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        n = ctypes.c_int(0)
        err = mc(specs[name][2], SPREAD_BYTES if specs[name][3] else 0,
                 ctypes.byref(n))
        fits = n.value if err == 0 else f"error {err}"
        fns[name] = (fn, {"registers": regs, "max_active_clusters": fits})
    return fns


def call(fn, cdf, u):
    B, V_ = cdf.shape
    out = torch.empty(B, dtype=torch.int32, device=cdf.device)
    vec = int(V_ % 4 == 0 and cdf.data_ptr() % 16 == 0)
    _build.check(fn(cdf.data_ptr(), u.data_ptr(), out.data_ptr(), B, V_, vec,
                    torch.cuda.current_stream().cuda_stream),
                 "variant")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", metavar="SRC",
                    help="the replaced design's cdf_search.cu, timed too")
    ap.add_argument("--out", help="also write the JSON result to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cdf_variants: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    earlier = smoke.earlier_cdf_fn(smoke.start_earlier_cdf(args.earlier))
    fns = build_variants()
    gen = torch.Generator(dev).manual_seed(args.seed)
    tiny = torch.empty(1, dtype=torch.int32, device=dev)
    result = {"card": smi, "V": V, "resources": {k: v[1] for k, v in
                                                 fns.items()},
              "fill_one_entry_device_ms": smoke.device_ms(
                  lambda: tiny.fill_(0)),
              "times": {}}
    for B in BATCHES:
        p = torch.softmax(torch.randn((B, V), generator=gen, device=dev) * 3,
                          dim=-1)
        c = torch.cumsum(torch.sort(p, dim=-1, descending=True)[0], dim=-1)
        u = torch.rand(B, generator=gen, device=dev)
        want = cs.invert_cdf(c, u)
        runs = {name: (lambda fn=fn: call(fn, c, u))
                for name, (fn, _) in fns.items()}
        if earlier is not None:
            runs["earlier"] = lambda: earlier(c, u)
        runs["searchsorted"] = lambda: torch.searchsorted(c, u[:, None])
        row = {k: {"ms": [], "device_ms": []} for k in runs}
        order = list(runs) + list(runs)[::-1]
        for name in order:
            if name != "searchsorted" and not any(
                    name.startswith(f"t256_l8_{part}_") for part in PARTS):
                got = runs[name]()
                torch.cuda.synchronize()
                smoke.check(torch.equal(got, want), f"{name} != plain at B {B}")
            row[name]["ms"].append(smoke.cuda_ms(runs[name]))
            row[name]["device_ms"].append(smoke.device_ms(runs[name]))
        row["bound_ms"] = smoke.bound(B * V * 4 + 8 * B, B * V)[0]
        result["times"][B] = row
        print(B, json.dumps({k: v["device_ms"] for k, v in row.items()
                             if isinstance(v, dict)}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
