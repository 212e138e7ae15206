"""The port's example twins (``examples/*_torch.py``) on the CPU at small
sizes, each with the reference example's own self-checks (every index kind
against ``np.searchsorted``, the service's answers against numpy, prefix
reuse, crash and resume). They import only ``repro_torch``."""
import importlib.util
import os

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_import_only_the_port():
    for name in ("quickstart_torch", "index_db_torch", "serve_batched_torch",
                 "train_tiny_torch"):
        src = open(os.path.join(EXAMPLES, f"{name}.py")).read()
        assert "import jax" not in src and "from jax" not in src
        assert "from repro." not in src and "import repro\n" not in src


def test_quickstart_twin():
    out = load("quickstart_torch").main("cpu", n=4096, q=256, reps=1)
    assert set(out) == {"binary", "css", "kary", "fast", "nitrogen",
                        "tiered"}


def test_index_db_twin():
    out = load("index_db_torch").main("cpu", n_rows=8192, batch=256,
                                      n_new=256, reps=1)
    assert out["busiest_range_rows"] > 0 and len(out["lookups_per_s"]) == 6


def test_serve_batched_twin():
    out = load("serve_batched_torch").main("cpu", steps=2, n_prompts=3)
    assert out["shape"] == [3, 2] and out["reused_tokens"] >= 128


@pytest.mark.parametrize("steps,every", [(8, 2)])
def test_train_tiny_twin(steps, every):
    out = load("train_tiny_torch").main("cpu", steps=steps, ckpt_every=every)
    assert out["steps"] == steps and out["resumed_at"] == 4
