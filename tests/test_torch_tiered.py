"""The port's tiered engine and ``core.api`` against the reference.

The same numpy keys, values and queries go through ``repro`` (JAX, Pallas
kernels in interpret mode) and ``repro_torch`` (on the CPU, the kernels'
plain versions); layouts, ranks, found flags and values must be
bit-identical. Also: state carried across from a reference index, every
``IndexConfig`` validation error, the not-yet-ported surface, and import
hygiene (the port never imports jax or the reference package)."""
import os
import re
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.engine import tiered as ref_tiered

import repro_torch
import repro_torch.core as pt_core
from repro_torch.engine import tiered as pt_tiered

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
I32 = np.iinfo(np.int32)


def make_case(name):
    """(keys, values, queries, build kwargs) of a named parity case. Every
    batch mixes hits, misses and queries past the last key."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kw = {}
    if name.startswith("i32_"):
        n = int(name[4:])
        keys = rng.integers(I32.min + 1, I32.max - 1, n).astype(np.int32)
        past = np.array([keys.max() + 1, I32.max - 1], np.int32)
        miss = rng.integers(I32.min + 1, I32.max - 1, 1500).astype(np.int32)
    elif name.startswith("f32_"):
        n = int(name[4:])
        keys = (rng.normal(size=n) * 1e3).astype(np.float32)
        keys[:2] = [0.0, -0.0]
        past = np.array([keys.max() * 2, 3.4e38], np.float32)
        miss = (rng.normal(size=1500) * 1e3).astype(np.float32)
    else:                                   # duplicate-heavy, narrow pages
        n = 5000
        keys = rng.integers(0, 40, n).astype(np.int32)
        past = np.array([40, 1000], np.int32)
        miss = np.arange(-2, 44, dtype=np.int32)
        kw = {"leaf_width": 128}
    hits = keys[rng.integers(0, n, 1500)]
    queries = np.concatenate([hits, miss, past]).astype(keys.dtype)
    values = rng.integers(I32.min, I32.max, n).astype(np.int32)
    return keys, values, rng.permutation(queries), kw


CASES = ["i32_32768", "i32_32769", "i32_1048576", "f32_32768", "f32_32769",
         "dups"]


@pytest.fixture(scope="module")
def ref_results():
    """Reference index and lookup per case, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            keys, values, queries, kw = make_case(name)
            idx = ref_core.build_index(
                keys, values, ref_core.IndexConfig(kind="tiered", **kw))
            res = idx.lookup(queries)
            cache[name] = (idx, tuple(np.asarray(a) for a in
                                      (res.rank, res.found, res.values)))
        return cache[name]
    return get


def ref_state(idx):
    t = idx.impl
    state = dict(pages=np.asarray(t.pages), seps=np.asarray(t.seps), n=t.n,
                 leaf_width=t.leaf_width, lw_pad=t.lw_pad,
                 num_pages=t.num_pages, tile=t.tile, top_kind=t.top_kind,
                 keys_sorted=np.asarray(idx.keys_sorted),
                 values_sorted=np.asarray(idx.values_sorted))
    if t.top_kind == "kary":
        state.update(top_tree=np.asarray(t.top.tree),
                     top_level_offsets=np.asarray(t.top.level_offsets))
    return state


def assert_same(res, want):
    rank, found, values = want
    assert res.rank.dtype == torch.int32
    np.testing.assert_array_equal(res.rank.numpy(), rank)
    np.testing.assert_array_equal(res.found.numpy(), found)
    np.testing.assert_array_equal(res.values.numpy(), values)


# ------------------------------------------------------------- layout
def test_plan_tiers_matches_reference():
    ns = [1, 127, 128, 129, 32768, 32769, 10**5, 2**20, 2**20 + 1, 2**24,
          10**8, 2**28, 10**9]
    for n in ns:
        for tile in (64, 128):
            assert pt_tiered.plan_tiers(n, tile=tile) == \
                ref_tiered.plan_tiers(n, tile=tile)
    assert pt_tiered.plan_tiers(2**24) == (2048, 8192, "kary")
    assert pt_tiered.plan_tiers(10**7, vmem_budget=2**20) == \
        ref_tiered.plan_tiers(10**7, vmem_budget=2**20)


@pytest.mark.parametrize("name", ["i32_32768", "i32_1048576", "f32_32769",
                                  "dups"])
def test_build_layout_matches_reference(name, ref_results):
    keys, _, _, kw = make_case(name)
    ref_idx = ref_results(name)[0].impl
    got = pt_tiered.build(np.sort(keys), device="cpu", **kw)
    for f in ("n", "leaf_width", "lw_pad", "num_pages", "tile", "top_kind"):
        assert getattr(got, f) == getattr(ref_idx, f), f
    np.testing.assert_array_equal(got.pages.numpy(), np.asarray(ref_idx.pages))
    np.testing.assert_array_equal(got.seps.numpy(), np.asarray(ref_idx.seps))
    if got.top_kind == "kary":
        np.testing.assert_array_equal(got.top.tree.numpy(),
                                      np.asarray(ref_idx.top.tree))
        assert got.top.level_offsets == ref_idx.top.level_offsets


# ------------------------------------------------------------- lookup
@pytest.mark.parametrize("plan", ["device", "host"])
@pytest.mark.parametrize("name", CASES)
def test_lookup_matches_reference(name, plan, ref_results):
    keys, values, queries, kw = make_case(name)
    idx = pt_core.build_index(
        keys, values, pt_core.IndexConfig(kind="tiered", plan=plan, **kw),
        device="cpu")
    assert idx.impl.top_kind == ref_results(name)[0].impl.top_kind
    assert_same(idx.lookup(queries), ref_results(name)[1])


@pytest.mark.parametrize("name", ["i32_32768", "i32_32769"])
def test_lookup_from_reference_arrays(name, ref_results):
    """State pulled out of the reference index with np.asarray answers the
    same queries identically in the port."""
    ref_idx, want = ref_results(name)
    _, _, queries, _ = make_case(name)
    idx = pt_core.from_reference_arrays(ref_state(ref_idx), device="cpu")
    assert idx.impl.top_kind == ref_idx.impl.top_kind
    assert_same(idx.lookup(queries), want)
    bare = pt_tiered.from_reference_arrays(ref_state(ref_idx), device="cpu")
    np.testing.assert_array_equal(pt_tiered.search(bare, queries).numpy(),
                                  want[0])


def test_lookup_empty_batch_both_plans():
    keys = np.arange(40000, dtype=np.int32)
    idx = pt_core.build_index(keys, keys, pt_core.IndexConfig(kind="tiered"),
                              device="cpu")
    for mode in ("device", "host"):
        out = pt_tiered.search(idx.impl, np.zeros(0, np.int32), plan=mode)
        assert out.shape == (0,) and out.dtype == torch.int32
    ranks, plan = pt_tiered.search_with_plan(idx.impl, np.zeros(0, np.int32))
    assert ranks.shape == (0,) and plan.steps_used == 0
    res = idx.lookup(np.zeros(0, np.int32))
    assert res.rank.shape == res.found.shape == res.values.shape == (0,)


def test_nitrogen_top_float_separators():
    """Float32 queries against the network's Python-float separators stay
    float32 compares: neighbours one ulp apart route to the right page."""
    keys = np.linspace(-1, 1, 20000, dtype=np.float32)
    idx = pt_tiered.build(keys, device="cpu")
    assert idx.top_kind == "nitrogen"
    seps = idx.seps.numpy()
    q = np.concatenate([seps, np.nextafter(seps, np.float32(np.inf)),
                        np.nextafter(seps, np.float32(-np.inf))])
    want = np.minimum(np.searchsorted(seps, q, side="left"),
                      idx.num_pages - 1)
    np.testing.assert_array_equal(idx.page_of(torch.from_numpy(q)).numpy(),
                                  want)


def test_searcher_and_int32_ranks():
    keys = np.arange(0, 50000, 5, dtype=np.int32)
    idx = pt_tiered.build(keys, device="cpu")
    q = np.array([-1, 0, 7, 49995, 10**6], np.int64)      # 64-bit input
    got = pt_tiered.searcher(idx)(q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [0, 0, 2, 9999, 10000])


# ------------------------------------------------------------- api surface
BAD_CONFIGS = [
    dict(kind="bogus"), dict(plan="bogus"),
    dict(kind="tiered", specialize=True, plan="host"),
    dict(mutable=True, delta_capacity=0), dict(maintenance="bogus"),
    dict(maintenance_interval_s=-1), dict(ckpt_keep=0),
    dict(journal_fsync="bogus"), dict(queue_capacity=0),
    dict(queue_deadline_s=-1), dict(queue_max_share=0.0),
    dict(queue_max_share=1.5), dict(queue_deadline_floor_s=-1),
    dict(queue_max_backlog=-1),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_index_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        ref_core.IndexConfig(**kw)
    with pytest.raises(ValueError) as got:
        pt_core.IndexConfig(**kw)
    assert str(got.value) == str(want.value)


def test_defaults_match_reference():
    assert pt_core.IndexConfig() == pt_core.IndexConfig(
        **{f: getattr(ref_core.IndexConfig(), f)
           for f in pt_core.IndexConfig.__dataclass_fields__})


@pytest.mark.parametrize("what", ["mutable", "kind", "specialize",
                                  "from_tuned"])
def test_unported_surface_raises(what):
    """What once was unported serves: a mutable store over another kind
    (item 12B) answers like numpy, kind="css" builds and answers like
    numpy, the bound index answers, and from_tuned reads a persisted
    profile, raising FileNotFoundError where there is none (the port
    commits no tuned profile)."""
    keys = np.arange(300, dtype=np.int32)
    cfg = {"mutable": dict(kind="css", mutable=True)}.get(what)
    if what == "kind":
        idx = pt_core.build_index(keys[::-1], config=pt_core.IndexConfig(
            kind="css"), device="cpu")
        q = np.array([-1, 0, 7, 150, 299, 300], np.int32)
        np.testing.assert_array_equal(idx.search(q).numpy(),
                                      np.searchsorted(keys, q))
    elif what == "specialize":
        idx = pt_core.build_index(keys, config=pt_core.IndexConfig(
            kind="tiered", specialize=True), device="cpu")
        assert idx.impl.search_spec is not None
        np.testing.assert_array_equal(idx.search(keys[::7]).numpy(),
                                      np.arange(0, 300, 7))
    elif what == "from_tuned":
        with pytest.raises(FileNotFoundError, match="autotune"):
            pt_core.IndexConfig.from_tuned("no_such_platform")
    else:
        store = pt_core.build_index(keys, config=pt_core.IndexConfig(**cfg),
                                    device="cpu")
        q = np.array([-1, 0, 7, 150, 299, 300], np.int32)
        res = store.lookup(q)
        np.testing.assert_array_equal(res.rank.numpy(),
                                      np.searchsorted(keys, q))
        assert res.found.tolist() == [False, True, True, True, True, False]
        np.testing.assert_array_equal(res.values[1:5].numpy(), q[1:5])


def test_build_index_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.build_index(np.arange(10, dtype=np.int32),
                                config=repro_torch.IndexConfig(kind="tiered"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tiered.build(np.arange(10, dtype=np.int32))


def test_tiered_rejects_unknown_top_and_plan():
    with pytest.raises(ValueError, match="unknown top tier"):
        pt_tiered.build(np.arange(10, dtype=np.int32), top="bogus",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown plan mode"):
        pt_tiered.build(np.arange(10, dtype=np.int32), plan="bogus",
                        device="cpu")
    idx = pt_tiered.build(np.arange(10, dtype=np.int32), device="cpu")
    with pytest.raises(ValueError, match="unknown plan mode"):
        pt_tiered.search(idx, np.zeros(4, np.int32), plan="bogus")


# ------------------------------------------------------------- hygiene
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    prog = textwrap.dedent(f"""
        import importlib, sys
        for m in {modules!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("BAD:" + ",".join(bad))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "BAD:"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_name_no_jax_or_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib)\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+repro(\.|\s|$)", text, re.M)
