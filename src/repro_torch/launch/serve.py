"""Serving launcher: batched generation with prefix-page reuse, on the
CUDA card (PyTorch port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --temperature 0.8 --top-p 0.9 --rounds 2 --tenants 4
    # off the card, at a tiny width:
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --tenants 2 --queue-max-share 0.5 --rounds 2

The prefix store is the mutable tiered store unless ``--wholesale`` asks
for the immutable index rebuilt on the probe after an insert. Probes go
through the store's micro-batch queue and sampled decode steps through
the decode queue unless ``--no-decode-queue``; ``--tenants N`` spreads
the requests over N admission lanes. ``--metrics-port`` serves the
metrics registry as Prometheus text on 127.0.0.1 and ``--trace-out``
writes the run's spans as Chrome trace JSON. ``--tune`` runs the
autotuner's smoke sweep first (``repro_torch.tune``) and serves with the
profile it persists; ``--tuned-profile PLATFORM`` serves with a persisted
one (``auto``: the current backend), the queue flags still winning. The
flags and defaults are the reference's, and so are the prompts
(``np.random.default_rng(0)``); weights are random, from the seed 0.
Flags whose subsystem is not ported yet exit with the message naming the
ROADMAP Queue 1 item that brings it.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def make_prompts(vocab: int, requests: int = 8, prompt_len: int = 48,
                 shared_prefix: int = 32) -> list:
    """The reference launcher's prompts: ``requests`` prompts of
    ``prompt_len`` tokens sharing their first ``shared_prefix``, drawn from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, shared_prefix)
    return [np.concatenate([
        shared, rng.integers(0, vocab, prompt_len - shared_prefix)])
        for _ in range(requests)]


def _unported(args) -> list:
    """(is set, what, ROADMAP item) for every unported flag or default."""
    return [
        (args.index != "tiered", f"--index {args.index}",
         "item 12 (the other index kinds)"),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, "
                         "'cpu' runs the kernels' plain versions")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--shared-prefix", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=1,
                    help="generate waves over the same prompts; rounds >= 2 "
                         "hit a warm store")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--index", default="tiered",
                    choices=["binary", "css", "kary", "fast", "nitrogen",
                             "tiered"])
    ap.add_argument("--wholesale", action="store_true",
                    help="rebuild the prefix index per insert batch instead "
                         "of the delta-merge write path")
    ap.add_argument("--queue-capacity", type=int, default=4096,
                    help="micro-batch queues: hard flush trigger "
                         "(pending queries or rows, DESIGN.md §7)")
    ap.add_argument("--queue-deadline-us", type=int, default=2000,
                    help="micro-batch probe queue: max in-queue wait")
    ap.add_argument("--no-queue-adapt", action="store_true",
                    help="freeze the queues' flush threshold instead of "
                         "steering it by executed-plan occupancy")
    ap.add_argument("--queue-max-share", type=float, default=1.0,
                    help="admission tier (DESIGN.md §7.1): hard cap on one "
                         "tenant's share of a flush, e.g. 0.25")
    ap.add_argument("--no-adaptive-deadline", action="store_true",
                    help="pay the full flush window regardless of the "
                         "EWMA arrival-rate estimate")
    ap.add_argument("--no-decode-queue", action="store_true",
                    help="sample decode steps inline instead of batching "
                         "their CDF inversions through the decode queue")
    ap.add_argument("--tenants", type=int, default=0,
                    help="spread requests round-robin over N tenant ids so "
                         "probes and decode steps ride per-tenant "
                         "admission lanes (0 = single default tenant)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot directory for the prefix store; the "
                         "store is saved there after the run, and the "
                         "mutable index journals its writes")
    ap.add_argument("--restore", action="store_true",
                    help="warm-start the prefix store from --ckpt-dir "
                         "(newest verifiable snapshot + journal replay)")
    ap.add_argument("--fsync", default="rotate",
                    choices=["never", "rotate", "always"],
                    help="journal durability: 'never' = OS page cache, "
                         "'rotate' = fsync at segment rotation, 'always' "
                         "= fsync every acknowledged write batch")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the metrics registry as Prometheus text "
                         "at http://127.0.0.1:PORT/metrics for the run "
                         "(0 = ephemeral port, printed at startup)")
    ap.add_argument("--metrics-selftest", action="store_true",
                    help="scrape the Prometheus endpoint once after the "
                         "run and check that the engine series parse "
                         "back; requires --metrics-port")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record host tracing spans for the whole run and "
                         "dump Chrome/Perfetto trace_event JSON to FILE")
    ap.add_argument("--tune", action="store_true",
                    help="run the platform autotuner micro-sweep first "
                         "(repro_torch.tune), persist the tuned profile, "
                         "then serve with it")
    ap.add_argument("--tuned-profile", default=None, metavar="PLATFORM",
                    help="serve with the persisted tuned profile for "
                         "PLATFORM ('auto' = current backend); "
                         "tile/leaf_width/queue knobs and specialize come "
                         "from the profile, CLI queue flags still win")
    args = ap.parse_args()
    if args.restore and not args.ckpt_dir:
        ap.error("--restore requires --ckpt-dir")
    if args.metrics_selftest and args.metrics_port is None:
        ap.error("--metrics-selftest requires --metrics-port")

    from ..core.util import not_ported
    for is_set, what, item in _unported(args):
        if is_set:
            sys.exit(str(not_ported(what, item)))

    import torch
    from ..configs import get_config
    from ..core import IndexConfig
    from ..core.util import resolve_device
    from ..engine.queue import tenant_summary
    from ..models import transformer as T
    from ..serve import SamplerConfig, ServeEngine
    from .. import obs

    device = resolve_device(args.device)
    srv = None
    if args.metrics_port is not None:
        srv, port = obs.start_http_server(args.metrics_port)
        print(f"metrics: http://127.0.0.1:{port}/metrics")
    if args.trace_out:
        obs.TRACER.enable()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    print(f"arch={args.arch} params={T.param_count(params)/1e6:.1f}M "
          f"prefix-index={args.index} device={device}")
    if args.tune:
        from ..tune import autotune
        prof, ppath = autotune(smoke=True, device=device)
        print(f"autotuned: {prof.knobs} -> {ppath}")
        if args.tuned_profile is None:
            args.tuned_profile = prof.platform
    index_kwargs = dict(kind=args.index, levels=2, compiled_node_width=3,
                        mutable=not args.wholesale,
                        queue_capacity=args.queue_capacity,
                        queue_deadline_s=args.queue_deadline_us * 1e-6,
                        queue_adapt=not args.no_queue_adapt,
                        queue_max_share=args.queue_max_share,
                        queue_adaptive_deadline=not args.no_adaptive_deadline,
                        journal_fsync=args.fsync)
    if args.tuned_profile is not None:
        platform = None if args.tuned_profile == "auto" else \
            args.tuned_profile
        index_config = IndexConfig.from_tuned(platform, **index_kwargs)
        print(f"tuned profile: tile={index_config.tile} "
              f"leaf_width={index_config.leaf_width} "
              f"specialize={index_config.specialize}")
    else:
        index_config = IndexConfig(**index_kwargs)
    eng = ServeEngine(
        cfg, params, max_len=args.max_len, page_size=args.page_size,
        index_config=index_config,
        decode_batching=not args.no_decode_queue,
        sampler=SamplerConfig(temperature=args.temperature, top_p=args.top_p))
    restore_s = None
    if args.restore:
        import time
        from ..serve.kv_cache import PrefixPageStore
        t0 = time.perf_counter()
        eng.store = PrefixPageStore.restore(
            args.ckpt_dir, index_config=eng.store.index_config,
            device=device)
        if eng.store._index is not None:      # one probe: servable
            eng.store._index.lookup(torch.zeros(1, dtype=torch.int32,
                                                device=device))
        restore_s = time.perf_counter() - t0
        print(f"restored prefix store: {len(eng.store.hashes)} pages "
              f"from {args.ckpt_dir}")
    prompts = make_prompts(cfg.vocab, args.requests, args.prompt_len,
                           args.shared_prefix)
    tenants = None
    if args.tenants > 0:
        tenants = [f"t{i % args.tenants}" for i in range(args.requests)]
    gen = torch.Generator(device).manual_seed(0)
    for _ in range(max(args.rounds, 1)):
        out = eng.generate(prompts, steps=args.steps, generator=gen,
                           tenants=tenants)
    s = eng.stats
    print(f"tokens out: {tuple(out.shape)}")
    print(f"prefill computed/reused: {s.prefill_tokens}/{s.reused_tokens}")
    print(f"decode: {s.decode_tokens} tokens in {s.decode_s:.2f}s "
          f"({s.decode_tokens/max(s.decode_s,1e-9):,.0f} tok/s)")
    print(f"prefix store: {eng.store.stats}")
    print(f"probe queue:  {s.probe_batches} fused batches in "
          f"{s.probe_s:.3f}s, mean executed-plan occupancy "
          f"{s.probe_occupancy:.3f}")
    if s.decode_flushes:
        print(f"decode queue: {s.decode_flushes} fused inversion batches, "
              f"mean occupancy {s.decode_occupancy:.3f}")
    # one registry helper renders every (path, tenant) row, the same rows
    # EngineStats.tenants exposes (DESIGN.md §9)
    for row in tenant_summary():
        print(f"  tenant[{row.path}:{row.tenant}]: {row.queries} queries / "
              f"{row.flushes} flushes, admitted {row.admitted}, "
              f"deferred {row.deferred}, drops {row.drops}, "
              f"wait mean/max {row.wait_mean_us:.0f}/"
              f"{row.wait_max_us:.0f}us, occ share {row.occupancy:.3f}")
    if eng.store.index_config.mutable:
        print(f"write path:   {eng.store.index_stats}")
    if restore_s is not None:
        print(f"restore:      {restore_s:.3f}s snapshot+journal-replay to "
              f"servable (no wholesale rebuild)")
    if args.ckpt_dir:
        path = eng.store.save(args.ckpt_dir)
        print(f"saved prefix store: {len(eng.store.hashes)} pages -> {path}")
    if args.trace_out:
        doc = obs.TRACER.export(args.trace_out)
        print(f"trace: {len(doc['traceEvents'])} events -> {args.trace_out}")
    if srv is not None:
        try:
            if args.metrics_selftest:
                _metrics_selftest(srv.server_address[1])
        finally:
            srv.shutdown()
            srv.server_close()


def _metrics_selftest(port: int):
    """Scrape our own Prometheus endpoint over TCP on 127.0.0.1 and check
    that the engine series are present and parse."""
    import urllib.request
    from .. import obs
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    parsed = obs.parse_prometheus(body)
    names = {n for n, _ in parsed}
    required = ["repro_queue_submits_total", "repro_queue_flushes_total",
                "repro_engine_op_seconds_bucket",
                "repro_engine_op_seconds_count"]
    missing = [n for n in required if n not in names]
    if missing:
        raise RuntimeError(f"metrics selftest: missing series {missing}")
    paths = {lab for n, lab in parsed
             if n == "repro_engine_op_seconds_count"}
    if not any('path="probe"' in p for p in paths):
        raise RuntimeError(f"metrics selftest: no probe path in {paths}")
    print(f"metrics selftest: {len(parsed)} samples, "
          f"{len(names)} series ok")


if __name__ == "__main__":
    main()
