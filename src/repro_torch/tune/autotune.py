"""Registry-driven knob sweep (DESIGN.md §10), PyTorch port of
``repro/tune/autotune.py``.

One **trial** = build a mutable tiered store at a sweep point, run the
three serving legs (point lookups, range scans, micro-batch flushes)
under a FRESH ``obs.Registry``, then read the objective out of that
registry: p50/p99 bucket bounds of ``engine_op_seconds{path=...}`` plus
the exact mean sidecar. There is no parallel timing harness — the tuner
measures exactly what serving measures, through the same histograms.

The sweep is staged to stay O(sum) instead of O(product): stage A sweeps
the index-layout knobs (``tile`` × ``leaf_width`` ×
``histogram_max_pages``) with the queue knobs pinned; stage B sweeps the
queue knobs (``queue_min_flush`` × ``queue_deadline_s``) at stage A's
winner. Scores compare lexicographically: the √2-bucketed
(p50 + 0.2·p99) sum first, the exact mean sum as the tie-break within a
bucket. The grids, weights and rules are the reference's.

The trials run on ``device`` (default: the CUDA card). The lookup and
scan legs' batches are uploaded once, before the measured reps, and each
rep waits for the device (``torch.cuda.synchronize``) where the
reference blocks on its result. On the card those two legs observe each
rep from the call to the device's completion (``_timed_reps``), not at
the call's dispatch boundary as the reference and the CPU do: a card
call returns once its work is queued, so its dispatch time is host time
that no swept knob moves, and it drifts by whole √2 buckets from one
tenth of a second to the next on a shared host. ``autotune(...)``
persists the winner and its registry snapshot via ``tune.profile``;
``verify_profile`` reloads it through ``IndexConfig.from_tuned`` and
checks that the recorded lookup p50 reproduces within 10% (or one √2
bucket, whichever is looser — bucket resolution is the measurement
floor).

    python -m repro_torch.tune.autotune --smoke [--profile-dir DIR]
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.util import resolve_device
from ..obs import NULL_REGISTRY, Registry, get_registry, use_registry
from .profile import TunedProfile, platform_key, save_profile

# per-path weights of the serving objective: lookups dominate, scans are
# heavier per call but rarer, flush cost amortizes across a batch
PATH_WEIGHTS = (("lookup", 1.0), ("scan", 0.5), ("flush", 0.25))
_SQRT2 = 2.0 ** 0.5

DEFAULT_GRID: Dict[str, List[Any]] = {
    "tile": [128, 256],
    "leaf_width": [None, 512, 1024],      # None = planner's auto width
    "histogram_max_pages": [16, 32, 64],
    "queue_min_flush": [32, 64, 128],
    "queue_deadline_s": [5e-4, 2e-3],
}

# the 2-point micro-sweep of the smoke run: one point per stage axis
SMOKE_GRID: Dict[str, List[Any]] = {
    "tile": [128, 256],
    "leaf_width": [None],
    "histogram_max_pages": [32],
    "queue_min_flush": [64],
    "queue_deadline_s": [2e-3],
}

_INDEX_KNOBS = ("tile", "leaf_width", "histogram_max_pages")
_QUEUE_KNOBS = ("queue_min_flush", "queue_deadline_s")


def _workload(n: int, q_n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(np.int64(4) * n, n, replace=False)) \
        .astype(np.int32)
    hits = rng.choice(keys, q_n // 2)
    misses = rng.randint(0, 4 * n, q_n - hits.size).astype(np.int32)
    q = np.concatenate([hits, misses]).astype(np.int32)
    rng.shuffle(q)
    lo = np.sort(rng.choice(keys, max(1, q_n // 64)))
    hi = (lo.astype(np.int64) + n // 8).clip(max=np.iinfo(np.int32).max) \
        .astype(np.int32)
    return keys, q, lo, hi


def _wait(device: torch.device) -> None:
    """Wait for the device's work, as the reference's block_until_ready."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_reps(fn, reps: int, path: str, device: torch.device) -> None:
    """``reps`` calls of ``fn``, each waited for. On the CPU a call's work
    is done when it returns, and it observes its own
    ``engine_op_seconds{path}``, as the reference's reps do. On the card
    each rep is observed from the call to the device's completion into
    the active registry, one ``engine_ops`` count with it, and the call's
    own dispatch-boundary observations are silenced."""
    if device.type != "cuda":
        for _ in range(reps):
            fn()
            _wait(device)
        return
    reg = get_registry()
    hist = reg.histogram("engine_op_seconds", path=path)
    ops = reg.counter("engine_ops", path=path)
    for _ in range(reps):
        t0 = time.perf_counter()
        with use_registry(NULL_REGISTRY):
            fn()
        _wait(device)
        hist.observe(time.perf_counter() - t0)
        ops.inc()


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def run_trial(knobs: Dict[str, Any], *, n: int = 20000, q_n: int = 2048,
              reps: int = 8, seed: int = 0, specialize: bool = True,
              device=None) -> Dict[str, Any]:
    """One sweep point: fresh store, fresh registry, three measured legs.
    Returns ``{"knobs", "objective", "score", "registry"}``."""
    from ..core.api import IndexConfig, build_index
    from ..engine import schedule
    from ..engine.queue import MicroBatchQueue, index_probe_fn

    device = resolve_device(device)
    keys, q, lo, hi = _workload(n, q_n, seed)
    cfg = IndexConfig(
        kind="tiered", mutable=True, specialize=specialize,
        tile=int(knobs.get("tile", 128)),
        leaf_width=knobs.get("leaf_width"),
        queue_min_flush=int(knobs.get("queue_min_flush", 64)),
        queue_deadline_s=float(knobs.get("queue_deadline_s", 2e-3)))
    reg = Registry()
    hmp = int(knobs.get("histogram_max_pages",
                        schedule.HISTOGRAM_MAX_PAGES))
    with schedule.plan_thresholds(max_pages=hmp):
        probe = None

        def probe_quiet(qq):
            # the queue leg measures DISPATCH cost (path="flush", observed
            # by the queue itself outside this scope); the store's inner
            # path="lookup" observation is silenced so the lookup
            # histogram holds only the uniform-shape rep leg — the series
            # verify_profile reproduces like-for-like
            with use_registry(NULL_REGISTRY):
                return probe(qq)

        def queue_round():
            queue = MicroBatchQueue(
                probe_quiet, min_flush=cfg.queue_min_flush,
                deadline_s=cfg.queue_deadline_s, timer=False, path="flush")
            futs = []
            chunk = max(1, cfg.queue_min_flush // 2)
            for i in range(0, q.size, chunk):
                futs.append(queue.submit(q[i: i + chunk]))
            queue.flush("manual")
            for f in futs:
                f.result()
            queue.close()
            _wait(device)

        # build + capture warmup OUTSIDE the trial registry (every leg,
        # including one full queue round so its batch shapes are
        # captured): the objective is steady-state serving latency, not
        # capture time
        with use_registry(NULL_REGISTRY):
            store = build_index(keys, None, cfg, device=device)
            probe = index_probe_fn(store)
            qd, lod, hid = (torch.from_numpy(a).to(device)
                            for a in (q, lo, hi))
            store.lookup(qd)
            store.scan_range(lod, hid)
            _wait(device)
            queue_round()
        with use_registry(reg):
            _timed_reps(lambda: store.lookup(qd), reps, "lookup", device)
            _timed_reps(lambda: store.scan_range(lod, hid), reps, "scan",
                        device)
            queue_round()
        store.close()
    objective, score = _objective(reg)
    return {"knobs": dict(knobs), "objective": objective,
            "score": list(score), "registry": reg.snapshot()}


def _objective(reg: Registry) -> Tuple[Dict[str, Any],
                                       Tuple[float, float]]:
    obj: Dict[str, Any] = {}
    bucket_score = 0.0
    mean_score = 0.0
    for path, w in PATH_WEIGHTS:
        h = reg.merged_histogram("engine_op_seconds", path=path)
        obj[path] = {"p50": h.quantile(0.5), "p99": h.quantile(0.99),
                     "mean": h.mean, "count": h.count}
        bucket_score += w * (obj[path]["p50"] + 0.2 * obj[path]["p99"])
        mean_score += w * obj[path]["mean"]
    obj["score"] = [bucket_score, mean_score]
    return obj, (bucket_score, mean_score)


def _points(grid: Dict[str, List[Any]],
            names: Iterable[str]) -> List[Dict[str, Any]]:
    names = [k for k in names if k in grid]
    return [dict(zip(names, vals))
            for vals in itertools.product(*(grid[k] for k in names))]


def autotune(grid: Optional[Dict[str, List[Any]]] = None, *,
             smoke: bool = False, n: int = 20000, q_n: int = 2048,
             reps: int = 8, seed: int = 0,
             platform: Optional[str] = None,
             profile_dir: Optional[str] = None,
             persist: bool = True,
             device=None) -> Tuple[TunedProfile, Optional[str]]:
    """Staged sweep -> winning ``TunedProfile`` (persisted unless
    ``persist=False``). Returns ``(profile, path_or_None)``."""
    device = resolve_device(device)
    grid = dict(SMOKE_GRID if smoke else DEFAULT_GRID, **(grid or {}))
    trials: List[Dict[str, Any]] = []

    def run_stage(points: List[Dict[str, Any]],
                  base: Dict[str, Any]) -> Dict[str, Any]:
        best = None
        for p in points:
            knobs = dict(base, **p)
            t = run_trial(knobs, n=n, q_n=q_n, reps=reps, seed=seed,
                          device=device)
            trials.append({k: t[k] for k in ("knobs", "objective", "score")})
            if best is None or tuple(t["score"]) < tuple(best["score"]):
                best = t
        return best

    pinned = {k: grid[k][0] for k in grid}
    stage_a = run_stage(_points(grid, _INDEX_KNOBS), pinned)
    stage_b = run_stage(_points(grid, _QUEUE_KNOBS), stage_a["knobs"])
    best = stage_b if tuple(stage_b["score"]) <= tuple(stage_a["score"]) \
        else stage_a
    knobs = dict(best["knobs"], specialize=True)
    dev_backend = "gpu" if device.type == "cuda" else "cpu"
    prof = TunedProfile(
        platform=platform_key(platform if platform is not None
                              else dev_backend),
        backend=dev_backend, device_kind=_device_kind(device),
        knobs=knobs, objective=best["objective"], trials=trials,
        registry=best["registry"])
    path = save_profile(prof, profile_dir) if persist else None
    return prof, path


def verify_profile(prof: TunedProfile, *,
                   profile_dir: Optional[str] = None, n: int = 20000,
                   q_n: int = 2048, reps: int = 8, seed: int = 0,
                   device=None) -> Dict[str, Any]:
    """Reload the profile through ``IndexConfig.from_tuned`` and re-run
    the lookup leg, timed as the trials time it: the recorded p50 must
    reproduce within 10% or one √2 bucket (the histogram's resolution
    floor), whichever is looser."""
    from ..core.api import IndexConfig, build_index

    device = resolve_device(device)
    cfg = IndexConfig.from_tuned(prof.platform, profile_dir=profile_dir,
                                 mutable=True)
    keys, q, _, _ = _workload(n, q_n, seed)
    reg = Registry()
    with use_registry(NULL_REGISTRY):
        store = build_index(keys, None, cfg, device=device)
        qd = torch.from_numpy(q).to(device)
        store.lookup(qd)
        _wait(device)
    with use_registry(reg):
        _timed_reps(lambda: store.lookup(qd), reps, "lookup", device)
    store.close()
    fresh = reg.merged_histogram("engine_op_seconds",
                                 path="lookup").quantile(0.5)
    recorded = float(prof.objective["lookup"]["p50"])
    lo_b, hi_b = recorded / _SQRT2, recorded * _SQRT2
    ok = (abs(fresh - recorded) <= 0.10 * recorded) or \
        (lo_b - 1e-12 <= fresh <= hi_b + 1e-12)
    return {"ok": bool(ok), "fresh_p50": fresh, "recorded_p50": recorded,
            "config": {"tile": cfg.tile, "leaf_width": cfg.leaf_width,
                       "specialize": cfg.specialize}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="sweep index/queue knobs, persist the platform profile")
    ap.add_argument("--smoke", action="store_true",
                    help="2-point micro-sweep")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card")
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args(argv)
    prof, path = autotune(smoke=args.smoke, n=args.n, q_n=args.queries,
                          reps=args.reps, seed=args.seed,
                          platform=args.platform,
                          profile_dir=args.profile_dir, device=args.device)
    print(f"tuned profile -> {path}")
    print(json.dumps({"knobs": prof.knobs,
                      "objective": prof.objective}, indent=2))
    if not args.no_verify:
        v = verify_profile(prof, profile_dir=args.profile_dir, n=args.n,
                           q_n=args.queries, reps=args.reps,
                           seed=args.seed, device=args.device)
        print(json.dumps({"verify": v}, indent=2))
        if not v["ok"]:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
