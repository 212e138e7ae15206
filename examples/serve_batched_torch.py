"""End-to-end serving example of the PyTorch port (the paper's kind of
workload: throughput): a small qwen3-family model on the CUDA card serves
batched requests with prefix-page reuse (NitroGen-compiled prefix index)
and top-p sampling.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import IndexConfig
from repro_torch.core.util import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import SamplerConfig, ServeEngine


def main(device=None, steps: int = 32, n_prompts: int = 8) -> dict:
    """Serves ``n_prompts`` prompts sharing a 64-token system prompt for
    ``steps`` sampled steps on ``device`` (default: the CUDA card); asserts
    that every request after the first reused the shared prefix and
    returns the engine's counts."""
    device = resolve_device(device)
    cfg = get_config("qwen3-0.6b").reduced(d_model=128, n_layers=4,
                                           vocab=2048)
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    print(f"model: qwen3-family reduced, "
          f"{T.param_count(params)/1e6:.1f}M params on {device}")

    engine = ServeEngine(
        cfg, params, max_len=160, page_size=16,
        index_config=IndexConfig(kind="nitrogen", levels=2,
                                 compiled_node_width=3),
        sampler=SamplerConfig(temperature=0.8, top_p=0.9),
    )

    rng = np.random.default_rng(1)
    system_prompt = rng.integers(0, cfg.vocab, 64)      # shared 4-page prefix
    prompts = [np.concatenate([system_prompt, rng.integers(0, cfg.vocab, 17)])
               for _ in range(n_prompts)]

    out = engine.generate(prompts, steps=steps,
                          generator=torch.Generator(device).manual_seed(7))
    s = engine.stats
    tok_s = s.decode_tokens / max(s.decode_s, 1e-9)
    print(f"generated: {tuple(out.shape)} tokens")
    print(f"prefill tokens computed : {s.prefill_tokens:5d}")
    print(f"prefill tokens REUSED   : {s.reused_tokens:5d} "
          f"(prefix cache, index={engine.store.index_config.kind})")
    print(f"decode throughput       : {tok_s:,.0f} tok/s")
    print(f"prefix store stats      : {engine.store.stats}")
    assert s.reused_tokens >= 64 * (len(prompts) - 1), "prefix reuse failed"
    print("OK: every request after the first reused the shared system prompt.")
    return {"shape": list(out.shape), "prefill_tokens": s.prefill_tokens,
            "reused_tokens": s.reused_tokens, "decode_tok_s": tok_s,
            "decode_s": s.decode_s, "store": dict(engine.store.stats)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
