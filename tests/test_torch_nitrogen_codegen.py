"""The generated NitroGen kernel's code against the reference, on the CPU.

``kernels/nitrogen_codegen.py`` writes one CUDA C++ source an index, every
separator of its compiled top a literal. The same text builds with the
host's C++ compiler (``csrc/nitrogen_template.cuh``'s host branch): each
case here builds it into ``tmp_path``, calls ``nitrogen_search_host``
through ctypes and holds its ranks bit for bit to the reference's jitted
``repro.core.nitrogen.search`` (the tiered top to the reference's
``page_of``) and to the port's plain version. Subnormal keys and queries
are held to numpy instead: XLA's CPU backend flushes them to zero in its
compares, the generated code and the port follow IEEE.

Each bottom's read path (``nitrogen_codegen.layout``: a short row key by
key, a lower bound through the stage array, the sample array and their
windows, a CSS row 16 bytes a load) is held so at several stage budgets,
at shapes the reference configs do not reach; the host build reports any
16-byte load from a misaligned address. The rows are checked to be
sorted and sentinel-padded, which the lower bound relies on.

Also: the literals read back from a source equal, in order, the
separators that the reference's network compares (its jaxpr's ``le``
literals), the build's hash follows the separators, and a compiled
kernel's release (nvcc and the driver stood in for) unloads its modules
once nothing holds it and deletes its build files only if retired.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nitrogen as ref_nitrogen
from repro.engine import tiered as ref_tiered
from repro_torch.core import nitrogen as pt_nitrogen
from repro_torch.engine import tiered as pt_tiered
from repro_torch.kernels import _build
from repro_torch.kernels import nitrogen_codegen as cg

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
# the reference test configs (tests/test_core_index.py), build arguments
CONFIGS = {
    "l2w3-binary": dict(levels=2, node_width=3),
    "l3w1-vector": dict(levels=3, node_width=1, bottom="vector"),
    "l2w2-css4": dict(levels=2, node_width=2, bottom="css",
                      css_node_width=4),
}
# the bottoms' read paths (kernels/nitrogen_codegen.layout) at shapes the
# reference configs do not reach: (build arguments, keys)
BOTTOM_CASES = {
    # 4 rows of 4,096: a lower bound with its stage, sample and windows
    "vector-wide": (dict(levels=2, node_width=1, bottom="vector"), 4 * 4096),
    # rows of 261 keys, not whole 16-byte pieces: no window, the last slot
    "vector-odd": (dict(levels=2, node_width=2, bottom="vector"), 2345),
    # 64 rows of 32, the last holding one key and 31 of padding
    "vector-tail": (dict(levels=3, node_width=3, bottom="vector"), 2017),
    "binary-tail": (dict(levels=3, node_width=3), 2017),
    # 16-key directory rows (16-byte loads), leaves of 17, the last block
    # mostly padding
    "css16-tail": (dict(levels=3, node_width=3, bottom="css",
                        css_node_width=16), 2017),
}
# stage budgets (bytes): the default, none, and two that stage some levels
# and leave others to the sample and the row
STAGE_BUDGETS = [None, 0, 64, 1024]
DTYPES = [np.int32, np.float32]
TIERED_PAGES = [256, 37]         # tiered tops: a full 256 and a partial 37
N_KEYS = 2345


@pytest.fixture(scope="module")
def cxx():
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        pytest.skip("no host C++ compiler to build the generated code with")
    return found


def host_kernels(cxx, sources: list, path) -> list:
    """Generated sources built for the host, by g++ processes started all
    at once: for each, (q, block_pad, css_dirs, stage, sample, clip) ->
    int32 ranks, numpy in and out; every 16-byte load the card would make
    is checked to be aligned."""
    builds = []
    for i, source in enumerate(sources):
        src = path.with_name(f"{path.name}{i}.cpp")
        src.write_text(source)
        lib_path = src.with_suffix(".so")
        builds.append((lib_path, subprocess.Popen(
            [cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
             "-I", str(_build.CSRC), "-o", str(lib_path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    runs = []
    for lib_path, proc in builds:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode()
        fn = ctypes.CDLL(str(lib_path)).nitrogen_search_host
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        runs.append(_host_run(fn))
    return runs


def _host_run(fn):
    def run(q, block_pad, css_dirs, stage, sample, clip):
        q = np.ascontiguousarray(q)
        out = np.full(q.size, -1, np.int32)
        misaligned = fn(q.ctypes.data, block_pad.ctypes.data,
                        None if css_dirs is None else css_dirs.ctypes.data,
                        stage.ctypes.data, sample.ctypes.data,
                        out.ctypes.data, q.size, clip)
        assert misaligned == 0, "a 16-byte load from a misaligned address"
        return out
    return run


def host_kernel(cxx, source: str, path):
    """One generated source built for the host (``host_kernels``)."""
    return host_kernels(cxx, [source], path)[0]


def index_args(idx, clip=None) -> tuple:
    """A port index's arrays as its host kernel takes them, with the clip."""
    css = None if idx.css_dirs is None else idx.css_dirs.numpy()
    return (idx.block_pad.numpy(), css, idx.stage.numpy(), idx.sample.numpy(),
            idx.n if clip is None else clip)


def run_index(cxx, idx, q, tmp_path, clip=None):
    """The port index's generated code on the host, over its arrays."""
    run = host_kernel(cxx, pt_nitrogen.kernel_source(idx), tmp_path / "ng")
    return run(q, *index_args(idx, clip))


def keys_for(dtype, rng, n=N_KEYS):
    """Keys with a run of the domain's low edge (INT32_MIN / -0.0) long
    enough to hold separators, duplicates and wide magnitudes; no
    subnormals (the reference flushes them)."""
    if dtype == np.int32:
        body = rng.integers(I32.min, I32.max - 1, n - 700, dtype=np.int64)
        body[:5] = I32.max - 1
        edge = np.full(600, I32.min)
    else:
        body = rng.normal(size=n - 700) * 10.0 ** rng.integers(-20, 20,
                                                               n - 700)
        body[:5] = [3.4e38, -3.4e38, 1.0, -1.0, 0.0]
        edge = np.full(600, -0.0)
    dups = rng.choice(body, 100)
    keys = np.concatenate([body, edge, dups]).astype(dtype)
    return keys[rng.permutation(keys.size)]


def queries_for(keys, rng):
    """The keys themselves, random values, the domain's edges and the
    sentinel; for floats also +-inf, +-0.0 and NaN."""
    if keys.dtype == np.int32:
        extra = [I32.min, I32.min + 1, I32.max, I32.max - 1, 0, -1]
        rand = rng.integers(I32.min, I32.max, 2000, dtype=np.int64)
    else:
        extra = [np.inf, -np.inf, 0.0, -0.0, np.nan, 3.4e38, -3.4e38,
                 np.finfo(np.float32).max, -np.finfo(np.float32).max]
        rand = rng.normal(size=2000) * 10.0 ** rng.integers(-20, 20, 2000)
    return np.concatenate([keys, rand, extra]).astype(keys.dtype)


def reference_literals(network, dtype) -> np.ndarray:
    """The separators the reference's network compares, in its trace's
    order: the scalar operand of every ``le`` in the jaxpr."""
    jaxpr = jax.make_jaxpr(network)(jnp.zeros(4, dtype)).jaxpr
    out = []

    def visit(jp):
        for e in jp.eqns:
            if e.primitive.name == "le":
                out.append(np.asarray(e.invars[1].val, dtype))
            for p in e.params.values():
                if hasattr(p, "jaxpr"):
                    visit(p.jaxpr)
    visit(jaxpr)
    return np.array(out, dtype)


def same_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, what
    view = {4: np.uint32, 8: np.uint64}[got.dtype.itemsize]
    np.testing.assert_array_equal(got.view(view), want.view(view),
                                  err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_generated_kernel_equals_the_reference(cxx, tmp_path, name, dtype):
    rng = np.random.default_rng(len(name))
    keys = keys_for(dtype, rng)
    cfg = CONFIGS[name]
    ref = ref_nitrogen.build(keys, **cfg)
    pt = pt_nitrogen.build(keys, **cfg, device="cpu")
    q = queries_for(keys, rng)
    got = run_index(cxx, pt, q, tmp_path)
    want = np.asarray(ref_nitrogen.searcher(ref)(q))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pt_nitrogen.search(pt, q).numpy())
    real = ~np.isnan(q) if dtype == np.float32 else slice(None)
    np.testing.assert_array_equal(
        got[real], np.searchsorted(np.sort(keys), q[real], "left"))
    # the low edge's run holds separators: INT32_MIN / -0.0 literals
    src = pt_nitrogen.kernel_source(pt)
    lit = "(-2147483647 - 1)" if dtype == np.int32 else "ng_f32(0x80000000u)"
    assert lit in src


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("pages", TIERED_PAGES)
def test_generated_tiered_top_equals_the_reference(cxx, tmp_path, pages,
                                                   dtype):
    """The tiered top over ``pages`` pages of 128: the vector bottom over
    the separators and the clip to the last page, in the same kernel."""
    rng = np.random.default_rng(pages)
    n = pages * 128 - (50 if pages == 37 else 0)       # 37: a partial tail
    keys = keys_for(dtype, rng, n)
    ref = ref_tiered.build(keys, leaf_width=128)
    pt = pt_tiered.build(keys, leaf_width=128, device="cpu")
    assert ref.top_kind == pt.top_kind == "nitrogen"
    assert ref.num_pages == pt.num_pages == pages
    q = queries_for(keys, rng)
    got = run_index(cxx, pt.top, q, tmp_path, clip=pages - 1)
    np.testing.assert_array_equal(got, np.asarray(ref.page_of(q)))
    np.testing.assert_array_equal(got, pt.page_of(torch.from_numpy(q))
                                  .numpy())


def sample_queries(keys, rng):
    """queries_for's edges and values, with a sample of the keys in place
    of all of them (the reference's vector bottom gathers a row a query)."""
    return queries_for(rng.choice(keys, 1500), rng)


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("name", list(BOTTOM_CASES))
def test_redesigned_bottoms_equal_the_reference(cxx, tmp_path, monkeypatch,
                                                name, dtype):
    """Each bottom's read path on the host, at each stage budget (levels
    read from the stage array, the sample array and its window, the row
    and its window, or the row's last slot): bit for bit with the
    reference's jitted search, the port's plain version and, for the
    queries that are not NaN, numpy."""
    cfg, n = BOTTOM_CASES[name]
    rng = np.random.default_rng(len(name) + n)
    keys = keys_for(dtype, rng, n)
    q = sample_queries(keys, rng)
    want = np.asarray(ref_nitrogen.searcher(ref_nitrogen.build(keys, **cfg))(q))
    real = ~np.isnan(q) if dtype == np.float32 else slice(None)
    np.testing.assert_array_equal(
        want[real], np.searchsorted(np.sort(keys), q[real], "left"))
    indexes, paths = [], set()
    for budget in STAGE_BUDGETS:
        if budget is not None:
            monkeypatch.setattr(cg, "STAGE_BYTES", budget)
        indexes.append(pt_nitrogen.build(keys, **cfg, device="cpu"))
    sources = [pt_nitrogen.kernel_source(pt) for pt in indexes]
    runs = host_kernels(cxx, sources, tmp_path / "ng")
    for budget, pt, src, run in zip(STAGE_BUDGETS, indexes, sources, runs):
        paths.add(tuple(cg.defined(src, k, 0) for k in (
            "NG_LINEAR", "NG_STAGE_LEVELS", "NG_SAMPLE", "NG_WIN_LOG2")))
        got = run(q, *index_args(pt))
        np.testing.assert_array_equal(got, want, err_msg=f"budget {budget}")
        np.testing.assert_array_equal(got, pt_nitrogen.search(pt, q).numpy())
    if name == "vector-wide":       # every lower-bound path was taken
        assert {p[2] for p in paths} == {0, 1}
        assert min(p[1] for p in paths) == 0 < max(p[1] for p in paths)


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("name", [*CONFIGS, *BOTTOM_CASES])
def test_rows_are_sorted_and_sentinel_padded(monkeypatch, name, dtype):
    """What the lower bound and the windows rely on: every bottom row (and
    every CSS directory row) is nondecreasing, the padding past a block's
    keys is the sentinel, and the stage and sample arrays hold the row
    slots that their levels probe (the sentinel past a row)."""
    monkeypatch.setattr(cg, "STAGE_BYTES", 64)
    cfg, n = BOTTOM_CASES.get(name, (CONFIGS.get(name), N_KEYS))
    keys = keys_for(dtype, np.random.default_rng(5), n)
    idx = pt_nitrogen.build(keys, **cfg, device="cpu")
    srt = np.sort(keys, kind="stable")
    sent = np.iinfo(dtype).max if dtype == np.int32 else np.inf
    rows = idx.block_pad.numpy().reshape(idx.num_blocks, -1)
    for b, row in enumerate(rows):
        real = srt[b * idx.block_width:(b + 1) * idx.block_width]
        same_bits(row[:real.size], real, f"block {b}")
        assert (row[real.size:] == sent).all(), f"block {b}'s padding"
        assert (row[1:] >= row[:-1]).all(), f"block {b} unsorted"
    if idx.bottom == "css":
        dirs = idx.css_dirs.numpy().reshape(-1, idx.css_w)
        assert (dirs[:, 1:] >= dirs[:, :-1]).all()
        return
    src = pt_nitrogen.kernel_source(idx)
    log2 = cg.row_log2(idx.block_pad_width)
    width = np.concatenate([rows, np.full((rows.shape[0], 2**log2
                                           - rows.shape[1]), sent,
                                          rows.dtype)], 1)
    lev = cg.defined(src, "NG_STAGE_LEVELS", 0)
    stage = idx.stage.numpy()
    slots = (np.arange(1, 2**lev) << (log2 - lev)) - 1
    same_bits(stage[:slots.size * idx.num_blocks],
              width[:, slots].reshape(-1), "stage")
    assert (stage[slots.size * idx.num_blocks:] == sent).all()
    win = cg.defined(src, "NG_WIN_LOG2", 0)
    if cg.defined(src, "NG_SAMPLE", 0):
        same_bits(idx.sample.numpy(),
                  width[:, (1 << win) - 1::1 << win].reshape(-1), "sample")
    else:
        assert idx.sample.numel() == 0


def literal_cases():
    for name in CONFIGS:
        for dtype in DTYPES:
            yield pytest.param(name, dtype, id=f"{name}-{dtype.__name__}")
    for pages in TIERED_PAGES:
        for dtype in DTYPES:
            yield pytest.param(pages, dtype,
                               id=f"tiered{pages}-{dtype.__name__}")


@pytest.mark.parametrize("case,dtype", literal_cases())
def test_source_literals_are_the_reference_separators(case, dtype):
    """Every separator's bits, read back from the generated source, equal
    the reference network's literals in order; no separator buffer."""
    rng = np.random.default_rng(7)
    if isinstance(case, int):
        keys = keys_for(dtype, rng, case * 128 - (50 if case == 37 else 0))
        ref = ref_tiered.build(keys, leaf_width=128).top
        pt = pt_tiered.build(keys, leaf_width=128, device="cpu").top
    else:
        keys = keys_for(dtype, rng)
        ref = ref_nitrogen.build(keys, **CONFIGS[case])
        pt = pt_nitrogen.build(keys, **CONFIGS[case], device="cpu")
    src = pt_nitrogen.kernel_source(pt)
    want = reference_literals(ref.network, dtype)
    f = pt.node_width + 1
    assert want.size == pt.node_width * (f**pt.levels - 1) // (f - 1)
    same_bits(cg.read_literals(src, dtype), want, "separators")
    assert src.count("q <= ") == want.size
    assert "NG_KEY* seps" not in src and "__constant__" not in src


def test_hash_follows_the_separators():
    rng = np.random.default_rng(3)
    keys = rng.choice(1 << 20, N_KEYS, replace=False).astype(np.int32)
    cfg = CONFIGS["l2w3-binary"]
    a = pt_nitrogen.kernel_source(pt_nitrogen.build(keys, **cfg,
                                                    device="cpu"))
    b = pt_nitrogen.kernel_source(pt_nitrogen.build(keys[::-1].copy(), **cfg,
                                                    device="cpu"))
    assert a == b
    assert _build.generated_path(cg.STEM, a) == \
        _build.generated_path(cg.STEM, b)
    srt = np.sort(keys)
    bw = -(-N_KEYS // 16)
    moved = srt.copy()
    moved[bw - 1] += 1                 # the first separator, still sorted
    assert moved[bw - 1] < moved[bw]
    c = pt_nitrogen.kernel_source(pt_nitrogen.build(moved, **cfg,
                                                    device="cpu"))
    assert c != a
    assert _build.generated_path(cg.STEM, c) != \
        _build.generated_path(cg.STEM, a)
    diff = cg.read_literals(c, np.int32) != cg.read_literals(a, np.int32)
    assert diff.sum() == 1


@pytest.mark.parametrize("name", [*CONFIGS, *BOTTOM_CASES])
def test_subnormals_follow_ieee(cxx, tmp_path, monkeypatch, name):
    """Subnormal keys and queries, and both zeros: the generated code
    equals numpy and the port's plain version (the reference's CPU
    backend flushes subnormals, so it is not the yardstick here), at the
    default stage budget and at one that leaves levels to the sample."""
    rng = np.random.default_rng(11)
    tiny = np.float32(1e-45) * np.arange(-200, 201, dtype=np.float32)
    keys = np.concatenate([tiny, [0.0, -0.0, 1e-38, -1e-38, 1.2e-38],
                           rng.normal(size=400) * 1e-30,
                           rng.normal(size=400)]).astype(np.float32)
    cfg = CONFIGS[name] if name in CONFIGS else BOTTOM_CASES[name][0]
    indexes = [pt_nitrogen.build(keys, **cfg, device="cpu")]
    monkeypatch.setattr(cg, "STAGE_BYTES", 64)
    indexes.append(pt_nitrogen.build(keys, **cfg, device="cpu"))
    q = np.concatenate([tiny + np.float32(1e-45) / 2, tiny, keys,
                        [0.0, -0.0, 2e-45, -2e-45, 1.1e-38]]
                       ).astype(np.float32)
    runs = host_kernels(cxx, [pt_nitrogen.kernel_source(pt)
                              for pt in indexes], tmp_path / "ng")
    for pt, run in zip(indexes, runs):
        got = run(q, *index_args(pt))
        np.testing.assert_array_equal(got, np.searchsorted(np.sort(keys), q))
        np.testing.assert_array_equal(got, pt_nitrogen.search(pt, q).numpy())
    lits = cg.read_literals(pt_nitrogen.kernel_source(pt), np.float32)
    assert (np.abs(lits) < np.finfo(np.float32).tiny).any()


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    """compile_top with nvcc and the driver stood in for: a build writes
    the source, a cubin and a log under ``tmp_path``; returns the builds
    made and the modules unloaded, as lists."""
    cg.release_unused()                  # nothing of another test's left
    built, unloaded = [], []

    def build_generated(stem, text):
        out = _build.generated_path(stem, text)
        for suffix in (".cu", ".cubin", ".log"):
            out.with_suffix(suffix).write_text(text)
        built.append(out)
        return out, 0.5, out.read_bytes()

    def load_function(image, device, name):
        return 1000 + len(built), f"{name}@{device}"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_generated", build_generated)
    monkeypatch.setattr(cg._driver, "load_function", load_function)
    monkeypatch.setattr(cg._driver, "unload",
                        lambda modules: unloaded.append(dict(modules)))
    yield built, unloaded
    cg.release_unused()                  # before the stand-ins go


def files_of(cubin: Path) -> list[bool]:
    return [cubin.with_suffix(s).exists() for s in (".cu", ".cubin", ".log")]


def test_released_kernel_unloads_and_keeps_its_files(fake_cuda):
    """One CompiledTop a source while an index holds it; once none does,
    its module is unloaded at the next compile_top and its build files
    stay, for the next build of the same index."""
    built, unloaded = fake_cuda
    loaded0 = cg.loaded()
    a = cg.compile_top("// a", torch.int32)
    assert cg.compile_top("// a", torch.int32) is a and len(built) == 1
    assert a.function(0) == f"{cg.KERNEL}@0" and a.compile_s == 0.5
    assert cg.loaded() == loaded0 + 1
    cubin = a.library
    del a
    assert cg.loaded() == loaded0 and unloaded == []
    b = cg.compile_top("// b", torch.int32)        # drains the release
    assert unloaded == [{0: 1001}]
    assert files_of(cubin) == [True] * 3
    del b
    assert cg.release_unused() == 0              # b loaded no module
    assert cg.compile_top("// a", torch.int32).library == cubin
    assert len(built) == 3                       # a is built anew


def test_retired_kernel_deletes_its_files_once_released(fake_cuda):
    """A retired kernel (a store's superseded top) keeps its files while
    an index holds it and deletes them on release; one that is compiled
    again before its release is live again and keeps them."""
    built, unloaded = fake_cuda
    a = cg.compile_top("// a", torch.int32)
    a.function(0)
    a.retire()
    assert files_of(a.library) == [True] * 3
    cubin = a.library
    del a
    assert cg.release_unused() == 1 and unloaded == [{0: 1001}]
    assert files_of(cubin) == [False] * 3
    c = cg.compile_top("// c", torch.int32)
    c.retire()
    again = cg.compile_top("// c", torch.int32)
    assert again is c
    del c, again
    cg.release_unused()
    assert files_of(built[-1]) == [True] * 3
