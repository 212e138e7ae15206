"""The flat kinds' search kernels (``kernels/flat_search.py``) held to the
reference's jitted searchers through their packed arguments.

A CUDA kernel cannot run here, so each wrapper's plain version stands for
it: ``flat_descent_plain`` re-states the kernel's per-query loop and reads
only what the wrapper hands the kernel (the level table of
``level_descent`` / ``page_descent``, the ending, n), ``flat_binary_plain``
and ``csb_search_plain`` the arguments of theirs. The same numpy keys and
queries (seeded) go through the reference's searcher (jitted, as its
``search`` runs it) and through those plain versions on the CPU: ranks and
found flags must be bit-identical, and equal numpy. Shapes are
``chip_smoke.py``'s phase 15 configurations at a few thousand keys, with
both intra-node searches, cutoffs 1 and 8, page depths 1-3 and a CSB+-tree
through a root split; ``csb_search_plain`` also reads the kernel's stage
(``csb_stage``) as the kernel reads it, held to the reference on trees at
w 2, 8 and 16 through their splits. Subnormal floats stay out of the JAX comparisons
(XLA's CPU backend flushes them in compares) and are held to numpy."""
import numpy as np
import pytest
import torch

from repro.core import csb_tree as ref_csb
from repro.core import css_tree as ref_css
from repro.core import fast_tree as ref_fast
from repro.core import kary as ref_kary
from repro.core import sorted_array as ref_sorted

from repro_torch.core import csb_tree as pt_csb
from repro_torch.core import css_tree as pt_css
from repro_torch.core import fast_tree as pt_fast
from repro_torch.core import kary as pt_kary
from repro_torch.core import sorted_array as pt_sorted
from repro_torch.kernels import flat_search as fs

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
N_KEYS, N_Q = 3_000, 1_024        # one query shape: one reference jit a kind


def int_data(rng):
    """Keys with duplicate runs and both ends of int32 (INT32_MIN up to the
    sentinel's neighbour INT32_MAX - 1); queries over the whole domain,
    every tenth key, the sentinel and its neighbours."""
    keys = np.concatenate([[I32.min, I32.min, I32.min + 1, I32.max - 1,
                            I32.max - 1],
                           rng.integers(-50_000, 50_000, N_KEYS - 5)])
    keys = np.sort(keys.astype(np.int32))
    keys[1::7] = keys[::7][:keys[1::7].size]            # duplicate runs
    keys = np.sort(keys)
    edge = [I32.min, I32.min + 1, I32.max - 2, I32.max - 1, I32.max, 0, -1]
    q = np.concatenate([rng.integers(-60_000, 60_000, N_Q - 600 - len(edge)),
                        rng.integers(I32.min, I32.max, 600 // 2),
                        keys[:: 2 * N_KEYS // 600][:600 // 2], edge])
    return keys, q.astype(np.int32)


def float_data(rng):
    """Keys with signed zeros, duplicate runs and +-3.4e38; queries with
    +-0.0, +-inf and NaN (below nothing: rank 0)."""
    keys = np.concatenate([[0.0, -0.0, 0.0, -3.4e38, 3.4e38],
                           rng.normal(size=N_KEYS - 5) * 1e3])
    keys = np.sort(keys.astype(np.float32))
    keys[1::7] = keys[::7][:keys[1::7].size]
    keys = np.sort(keys)
    edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38]
    q = np.concatenate([rng.normal(size=N_Q - 300 - len(edge)) * 1e3,
                        keys[:: N_KEYS // 300][:300], edge])
    return keys, q.astype(np.float32)


@pytest.fixture(scope="module", params=["int32", "float32"])
def data(request):
    rng = np.random.default_rng(29)
    keys, q = (int_data if request.param == "int32" else float_data)(rng)
    return keys, q, torch.from_numpy(q)


def same(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def stage_of(idx):
    """The kernel's stage of a CPU index, built as ``build`` builds it for
    an index on the card (on the CPU the kind's search runs its plain
    composition and the index holds none)."""
    if isinstance(idx, pt_sorted.SortedArrayIndex):
        return fs.binary_stage(idx.keys_pad, idx.n_pad, idx.linear_cutoff,
                               device="cpu")
    if isinstance(idx, pt_kary.KaryTreeIndex):
        return fs.descent_stage(idx.tree, pt_kary.descent_args(idx),
                                n=idx.n, device="cpu")
    css = isinstance(idx, pt_css.CSSTreeIndex)
    mod, nodes = (pt_css, idx.dir_keys) if css else (pt_fast, idx.pages)
    return fs.descent_stage(nodes, mod.descent_args(idx), idx.leaf_pad,
                            idx.leaf_width, n=idx.n, device="cpu")


def rank_of(keys, q) -> np.ndarray:
    """numpy's searchsorted-left, NaN queries at 0 as a count of keys < q
    gives them (numpy sorts NaN past every key)."""
    return np.where(np.isnan(q.astype(np.float64)), 0,
                    np.searchsorted(keys, q)).astype(np.int32)


# ---------------------------------------------------------------- binary
@pytest.mark.parametrize("cutoff", [1, 8, 64])
def test_flat_binary_args_match_the_reference(data, cutoff):
    keys, q, qt = data
    ref = ref_sorted.build(keys, linear_cutoff=cutoff)
    pt = pt_sorted.build(keys, linear_cutoff=cutoff, device="cpu")
    got = fs.flat_binary(pt.keys_pad, qt, n_pad=pt.n_pad,
                         cutoff=pt.linear_cutoff, n=pt.n, stage=stage_of(pt))
    same(got, ref_sorted.search(ref, q))
    same(got, rank_of(keys, q))
    same(pt_sorted.search(pt, q), got)


# -------------------------------------------------------- css, kary, fast
CSS = [(128, "vector"), (128, "binary"), (16, "vector"), (16, "binary"),
       (1, "vector"), (3, "vector"), (15, "vector"), (127, "vector")]


@pytest.mark.parametrize("w,intra", CSS, ids=[f"w{w}-{i}" for w, i in CSS])
def test_css_descent_args_match_the_reference(data, w, intra):
    keys, q, qt = data
    ref = ref_css.build(keys, node_width=w, intra=intra)
    pt = pt_css.build(keys, node_width=w, intra=intra, device="cpu")
    d = pt_css.descent_args(pt)
    assert d.page_row == tuple(o // w for o in pt.level_offsets)
    assert d.page_rows == (1,) * pt.depth and d.level_row == (0,) * pt.depth
    assert d.starts == 2**pt.depth - 1 and d.intra == intra
    got = fs.flat_descent(qt, pt.dir_keys, d, pt.leaf_pad, pt.leaf_width,
                          ending="leaf", n=pt.n, stage=stage_of(pt))
    same(got, ref_css.search(ref, q))
    same(got, rank_of(keys, q))
    same(pt_css.search(pt, q), got)


def test_kary_descent_args_match_the_reference(data):
    keys, q, qt = data
    ref = ref_kary.build(keys, node_width=127)
    pt = pt_kary.build(keys, node_width=127, device="cpu")
    d = pt_kary.descent_args(pt)
    assert pt.depth == 2 and d.page_row == (0, 1) and d.starts == 0b11
    got = fs.flat_descent(qt, pt.tree, d, ending="rank", n=pt.n,
                          stage=stage_of(pt))
    same(got, ref_kary.search(ref, q))
    same(got, rank_of(keys, q))


FAST = [(15, 1), (15, 2), (15, 3), (127, 2), (3, 2)]


@pytest.mark.parametrize("w,pd", FAST, ids=[f"w{w}-pd{p}" for w, p in FAST])
def test_fast_descent_args_match_the_reference(data, w, pd):
    """Search and leaf_page_of; the level table against FAST's page
    arithmetic (core.fast_tree._page_size)."""
    keys, q, qt = data
    ref = ref_fast.build(keys, node_width=w, page_depth=pd)
    pt = pt_fast.build(keys, node_width=w, page_depth=pd, device="cpu")
    d = pt_fast.descent_args(pt)
    lvl = 0
    for g, gd in enumerate(pt.group_depths):
        assert d.starts >> lvl & 1
        assert d.page_row[lvl] == pt.group_offsets[g] // w
        assert d.page_rows[lvl] == pt_fast._page_size(w, gd) // w
        for dl in range(gd):
            assert d.level_row[lvl + dl] == pt_fast._page_size(w, dl) // w
            assert (d.starts >> (lvl + dl) & 1) == (dl == 0)
        lvl += gd
    assert d.depth == pt.depth
    got = fs.flat_descent(qt, pt.pages, d, pt.leaf_pad, pt.leaf_width,
                          ending="leaf", n=pt.n, stage=stage_of(pt))
    same(got, ref_fast.search(ref, q))
    same(got, rank_of(keys, q))
    page = fs.flat_descent(qt, pt.pages, d, ending="descent",
                           stage=stage_of(pt))
    same(page, ref_fast.leaf_page_of(ref, q))
    same(pt_fast.leaf_page_of(pt, q), page)


# ------------------------------------------------------------------- CSB+
def test_csb_search_args_match_the_reference_through_a_root_split():
    """A root leaf split into a root over two leaves, then inserts that
    split leaves, grow the root and fall back to a rebuild: after each
    stage the snapshot the wrapper takes answers as the reference's tree
    (its root, height and node arrays too). A query equal to the sentinel
    reads as found where its leaf has a free slot, in both packages, so
    numpy checks the others."""
    rng = np.random.default_rng(8)
    keys = np.arange(0, 20, 5, dtype=np.int32)    # a half-full root leaf
    ref, pt = ref_csb.CSBTree.build(keys, w=8), \
        pt_csb.CSBTree.build(keys, w=8, device="cpu")
    assert pt.height == 1
    q = np.concatenate([np.arange(-3, 2_050, 2), [I32.min, I32.max - 1,
                                                  I32.max]])[:N_Q]
    q = q.astype(np.int32)
    stages = [np.array([1, 2, 3, 4, 6], np.int32),    # fill it, split it
              rng.integers(0, 2_000, 60).astype(np.int32),
              rng.integers(0, 2_000, 400).astype(np.int32)]
    heights = []
    for new in stages:
        for k in new:
            assert ref.insert(k) == pt.insert(k)
        keys_d, child, leaf_keys, root, height = pt.snapshot()
        assert (root, height) == ref.snapshot()[3:]
        for mine, theirs in zip((keys_d, child, leaf_keys), ref.snapshot()):
            same(mine, theirs)
        heights.append(height)
        got = fs.csb_search(torch.from_numpy(q), keys_d, child, leaf_keys,
                            root=root, height=height)
        same(got, ref.search(q))
        real = q != I32.max
        same(got[real], np.isin(q, pt.iter_keys())[real])
        same(pt.search(q), got)
    assert heights[0] == 2 and heights[-1] > heights[0]


def csb_queries(rng, keys: np.ndarray) -> np.ndarray:
    """Every key, its neighbours, random queries over the keys' span, and
    the edges: below every key, the sentinel, for floats +-inf, NaN and
    both zeros (N_Q of them: one reference jit a tree shape)."""
    pick = rng.choice(keys, min(keys.size, N_Q // 4), replace=False)
    if keys.dtype == np.int32:
        edge = [I32.min, I32.max - 1, I32.max, 0, keys[0] - 1]
        near = np.concatenate([pick - 1, pick + 1])
        spread = rng.integers(int(keys[0]) - 50, int(keys[-1]) + 50, N_Q)
    else:
        edge = [-np.inf, np.inf, np.nan, -0.0, 0.0, keys[0] - 1.0]
        near = np.concatenate([pick - 0.5, pick + 0.25])
        spread = rng.uniform(keys[0] - 50, keys[-1] + 50, N_Q)
    q = np.concatenate([edge, pick, near, spread]).astype(keys.dtype)
    return q[:N_Q]


def csb_growth(dtype, w: int, rng):
    """A root leaf half full, then inserts that fill and split it (a root
    split), split leaves, grow the root and, where a parent is full, fall
    back to a rebuild: the inserts of each stage."""
    first = (np.arange(0, 5 * max(w // 2, 1), 5)).astype(dtype)
    fill = np.append(first + 1, first[-1] + 2).astype(dtype)
    pool = rng.permutation(np.arange(1, 40 * w * w, 3))
    return first, [fill, pool[:4 * w].astype(dtype),
                   pool[4 * w:4 * w + 30 * w * w // 4].astype(dtype)]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("w", [2, 8, 16])
def test_csb_staged_descent_matches_the_reference(w, dtype, monkeypatch):
    """The kernel's staged descent, emulated by the plain version over
    ``csb_stage``, against the plain descent and the reference's
    ``_search``, after each stage of a tree's growth (a root split, leaf
    splits, a rebuild where a parent fills), and at stage budgets that
    hold nothing, the root alone or a level and a half (the top does not
    fit) beside the port's."""
    rng = np.random.default_rng(31 + w)
    first, stages = csb_growth(dtype, w, rng)
    ref = ref_csb.CSBTree.build(first, w=w)
    pt = pt_csb.CSBTree.build(first, w=w, device="cpu")
    builds = []
    real_build = pt_csb.CSBTree.build.__func__
    monkeypatch.setattr(pt_csb.CSBTree, "build", classmethod(
        lambda cls, *a, **k: builds.append(1) or real_build(cls, *a, **k)))
    heights = [pt.height]
    for new in stages:
        for k in new:
            assert ref.insert(k) == pt.insert(k)
        snap = pt.snapshot()
        keys_d, child, leaf_keys, root, height = snap
        assert (root, height) == ref.snapshot()[3:]
        heights.append(height)
        q = csb_queries(rng, np.sort(pt.iter_keys()))
        qt = torch.from_numpy(q)
        want = ref.search(q)
        plain = fs.csb_search_plain(qt, *snap[:3], root=root, height=height)
        same(plain, want)
        row = -(-w * q.itemsize // 16) * 16
        budgets = [fs.CSB_STAGE_BYTES, 0, fs.csb_stage_bytes(1, row),
                   fs.csb_stage_bytes(w + 2, row)]
        for budget in budgets:
            monkeypatch.setattr(fs, "CSB_STAGE_BYTES", budget)
            st = fs.csb_stage(keys_d, child, root, height, device="cpu")
            assert st.nbytes <= budget and st.levels <= height - 1
            assert st.levels == 0 or st.nodes >= 1
            same(fs.csb_search(qt, *snap[:3], root=root, height=height,
                               stage=st), want, f"budget {budget}")
        monkeypatch.setattr(fs, "CSB_STAGE_BYTES", budgets[0])
    assert heights[0] == 1 and heights[1] == 2 and heights[-1] >= 3
    assert builds, "no insert fell back to a rebuild"


def test_csb_stage_holds_the_top_in_breadth_first_order():
    """The stage of a bulk-loaded tree: every inner level down to the
    budget, each node's key row (sentinel padded to whole 16-byte pieces)
    and its link (the first copied child, then the child group), read
    back against a walk of the host tree."""
    keys = np.arange(0, 3 * 4_000, 3, dtype=np.int32)
    t = pt_csb.CSBTree.build(keys, w=8, device="cpu")
    assert t.stage is None                  # the CPU's search is plain
    snap = t.snapshot()
    st = fs.csb_stage(*snap[:2], t.root, t.height, device="cpu")
    assert t.height == 5 and st.levels == 4 and st.stride == 8
    level, order, links = [t.root], [], []
    for lev in range(st.levels):
        order += level
        nxt = []
        for nid in level:
            kids = [int(t.child[nid]) + c for c in range(t.nlen[nid] + 1)]
            links.append(len(order) + len(nxt) if lev + 1 < st.levels
                         else int(t.child[nid]))
            nxt += kids
        level = nxt
    assert st.nodes == len(order)
    np.testing.assert_array_equal(st.rows.numpy(), t.keys[order])
    np.testing.assert_array_equal(st.link.numpy(), links)
    assert st.nbytes == fs.csb_stage_bytes(len(order), 32) and \
        st.nbytes % 16 == 0
    for w, dtype, stride in ((3, np.int32, 4), (5, np.float32, 8),
                             (3, np.int64, 4), (16, np.float64, 16)):
        small = pt_csb.CSBTree.build(np.arange(200).astype(dtype), w=w,
                                     device="cpu")
        s = fs.csb_stage(*small.snapshot()[:2], small.root, small.height,
                         device="cpu")
        assert s.stride == stride and s.rows.dtype == torch.from_numpy(
            np.zeros(0, dtype)).dtype
        assert (s.rows[:, w:] == fs.sentinel_for(dtype)).all()


def test_csb_stage_stops_at_a_ragged_node_and_clamps():
    """A hand-made tree whose root's child group holds a leaf beside inner
    nodes (a ragged path: the node stays) and a child group that runs past
    the arrays (clamped): the stage holds the root alone, and the staged
    descent equals the plain one and the reference's ``_search``."""
    sent = I32.max
    keys = np.full((8, 2), sent, np.int32)
    keys[0], keys[2], keys[3] = [10, 20], [15, sent], [25, 30]
    leaf = np.full((8, 2), sent, np.int32)
    leaf[1], leaf[4], leaf[5], leaf[6], leaf[7] = \
        [5, 10], [11, 15], [16, 20], [21, 25], [26, 30]
    child = np.array([1, -1, 4, 6, -1, -1, -1, -1], np.int32)
    q = np.concatenate([np.arange(-3, 45), [I32.min, sent - 1, sent]]
                       ).astype(np.int32)
    st = fs.csb_stage(keys, child, 0, 3, device="cpu")
    assert st.levels == 1 and st.nodes == 1 and st.link.tolist() == [1]
    args = [torch.from_numpy(a) for a in (keys, child, leaf)]
    got = fs.csb_search(torch.from_numpy(q), *args, root=0, height=3,
                        stage=st)
    same(got, fs.csb_search_plain(torch.from_numpy(q), *args, root=0,
                                  height=3))
    same(got, ref_csb._search(keys, child, leaf, q, root=0, height=3))
    assert got.numpy()[q == 30] and not got.numpy()[q == 31]


# ----------------------------------------------------- subnormals, numpy
def test_subnormals_follow_ieee():
    """Subnormal keys and queries, against numpy (IEEE, as the kernels
    compare): XLA's CPU backend flushes them, so no reference here."""
    keys = np.sort(np.array([-3e-45, -1e-45, -0.0, 0.0, 1e-45, 2e-45, 3e-45,
                             1e-40, 1.2e-38, 1.0], np.float32))
    q = np.array([-2e-45, -1e-45, -0.0, 0.0, 1e-45, 1.5e-45, 2e-45, 5e-41,
                  1e-40, 2e-38, np.nan], np.float32)
    qt, want = torch.from_numpy(q), rank_of(keys, q)
    b = pt_sorted.build(keys, linear_cutoff=8, device="cpu")
    same(fs.flat_binary(b.keys_pad, qt, n_pad=b.n_pad, cutoff=8, n=b.n,
                        stage=stage_of(b)), want)
    for intra in ("vector", "binary"):
        c = pt_css.build(keys, node_width=2, intra=intra, device="cpu")
        same(fs.flat_descent(qt, c.dir_keys, pt_css.descent_args(c),
                             c.leaf_pad, c.leaf_width, ending="leaf", n=c.n,
                             stage=stage_of(c)), want)
    k = pt_kary.build(keys, node_width=3, device="cpu")
    same(fs.flat_descent(qt, k.tree, pt_kary.descent_args(k), ending="rank",
                         n=k.n, stage=stage_of(k)), want)
    f = pt_fast.build(keys, node_width=1, page_depth=2, device="cpu")
    same(fs.flat_descent(qt, f.pages, pt_fast.descent_args(f), f.leaf_pad,
                         f.leaf_width, ending="leaf", n=f.n,
                         stage=stage_of(f)), want)
    t = pt_csb.CSBTree.build(keys, w=2, device="cpu")
    same(fs.csb_search(qt, *t.snapshot()[:3], root=t.root, height=t.height),
         np.isin(q, keys))


# ------------------------------------------------- the stage and samples
@pytest.mark.parametrize("w", [15, 16, 128])
def test_kary_stage_widths_match_the_reference(data, w):
    """The k-ary tree at a narrow, an aligned and a wide node, through the
    plain version over its stage (live nodes, samples)."""
    keys, q, qt = data
    ref = ref_kary.build(keys, node_width=w)
    pt = pt_kary.build(keys, node_width=w, device="cpu")
    got = fs.flat_descent(qt, pt.tree, pt_kary.descent_args(pt),
                          ending="rank", n=pt.n, stage=stage_of(pt))
    same(got, ref_kary.search(ref, q))
    same(got, rank_of(keys, q))


def test_descent_stage_arrays():
    """The stage of a css w 128 directory over 40,000 keys (2 levels, 311
    live leaf blocks), held to the arrays it is built from: each level's
    live nodes (a node whose first key is the sentinel is dead), each
    live node's sample row (keys 15, 31, ..., 111, then a sentinel pad),
    each live leaf block's (keys 15, ..., 127 of its 129), and the staged
    levels under the budget; FAST's page-group boundary; kary's live
    nodes past the real ranks."""
    keys = np.arange(0, 80_000, 2, dtype=np.int32)
    c = pt_css.build(keys, node_width=128, device="cpu")
    st, d = stage_of(c), pt_css.descent_args(c)
    rows = c.dir_keys.numpy().reshape(-1, 128)
    assert st.live == (1, 3) and st.sample_width == 8
    assert st.sample_row == (0, 1)
    smp = st.sample.numpy()
    for lev, j, row in ((0, 0, 0), (1, 0, 1), (1, 2, 3)):
        got = smp[(st.sample_row[lev] + j) * 8:][:8]
        assert np.array_equal(got[:7], rows[row, 15:112:16])
        assert got[7] == I32.max
    leaf = smp[st.leaf_sample_at:].reshape(-1, 8)
    blocks = c.leaf_pad.numpy().reshape(-1, 129)
    assert leaf.shape[0] == -(-keys.size // 129) == 311
    assert np.array_equal(leaf, blocks[:311, 15:128:16])
    assert (st.stage_levels, st.stage_rows) == (2, 130)   # 69,160 bytes
    assert np.array_equal(st.table[:6], [0, 1, 1, 1, 0, 0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fs, "STAGE_BYTES", 129 * 532)
        root = fs.descent_stage(c.dir_keys, d, c.leaf_pad, 129, n=c.n,
                                device="cpu")
    assert (root.stage_levels, root.stage_rows) == (1, 1)
    f = pt_fast.build(keys, node_width=15, page_depth=2, device="cpu")
    fst = stage_of(f)
    assert (fst.stage_levels, fst.stage_rows) == (3, 273)
    assert fst.sample.numel() == 0 and fst.sample_width == 0
    with pytest.MonkeyPatch.context() as mp:   # the first page group alone
        mp.setattr(fs, "STAGE_BYTES", 272 * 64)
        group = fs.descent_stage(f.pages, pt_fast.descent_args(f),
                                 f.leaf_pad, 16, n=f.n, device="cpu")
    assert (group.stage_levels, group.stage_rows) == (2, 17)
    k = pt_kary.build(keys, node_width=127, device="cpu")
    assert k.depth == 3 and stage_of(k).live == (1, 3, -(-keys.size // 128))


def test_binary_stage_arrays():
    """flat_binary's stage: the probe keys of its first levels in
    Eytzinger order and the last key of every 32-byte window up to the
    first sentinel; the levels shrink with the budget and the ranks do
    not move."""
    keys = np.sort(np.random.default_rng(5).integers(
        -10**6, 10**6, 5_000)).astype(np.int32)
    b = pt_sorted.build(keys, linear_cutoff=1, device="cpu")
    st, kp = stage_of(b), b.keys_pad.numpy()
    assert (b.n_pad, st.top, st.last) == (8192, 12, 0)
    assert st.levels == 13
    assert st.stage[0] == kp[4095]
    assert np.array_equal(st.stage.numpy()[1:3], kp[[2047, 6143]])
    assert np.array_equal(st.sample.numpy(), kp[7:5000 // 8 * 8:8])
    q = torch.from_numpy(np.concatenate([keys[::7], [I32.min, I32.max],
                                         keys[-3:] + 1]).astype(np.int32))
    want = rank_of(keys, q.numpy())
    for budget in (0, 64, 4096):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fs, "STAGE_BYTES", budget)
            for cut in (1, 3, 8, 64):
                s = fs.binary_stage(b.keys_pad if cut == 1 else
                                    pt_sorted.build(keys, linear_cutoff=cut,
                                                    device="cpu").keys_pad,
                                    b.n_pad, cut, device="cpu")
                assert s.levels == min(max(budget // 4 + 1, 1).bit_length()
                                       - 1, 13 - s.last)
                got = fs.flat_binary_plain(
                    b.keys_pad, q, n_pad=b.n_pad, cutoff=cut, n=b.n,
                    stage=s)
                ref = ref_sorted.search(ref_sorted.build(
                    keys, linear_cutoff=cut), q.numpy()) if cut in (1, 8) \
                    else pt_sorted.search_plain(pt_sorted.build(
                        keys, linear_cutoff=cut, device="cpu"), q)
                same(got, np.asarray(ref), f"budget {budget} cut {cut}")
    same(fs.flat_binary_plain(b.keys_pad, q, n_pad=b.n_pad, cutoff=1,
                              n=b.n, stage=st), want)


def test_table_ends_follow_numpy():
    """A directory of depth 0 (one leaf block) and deep ones (css w 1 over
    40,000 keys: 15 levels; FAST w 1), through the plain versions over
    their stages, against numpy."""
    rng = np.random.default_rng(12)
    keys = np.sort(rng.integers(-10**6, 10**6, 40_000)).astype(np.int32)
    q = np.concatenate([rng.integers(-2 * 10**6, 2 * 10**6, 2_000),
                        keys[::41], [I32.min, I32.max]]).astype(np.int32)
    qt = torch.from_numpy(q)
    for ks, kind, w in ((keys[:100], pt_css, 128), (keys[:100], pt_fast, 127),
                        (keys, pt_css, 1), (keys, pt_fast, 1)):
        idx = kind.build(ks, node_width=w, device="cpu")
        assert idx.depth == (0 if ks.size == 100 else 15)
        same(kind.search(idx, qt), rank_of(ks, q), f"{kind.__name__} w{w}")


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_eight_byte_keys_follow_numpy(dtype):
    """int64 / float64 keys, as the entry points take them (a block of 8
    keys, a window of 4), against numpy: every flat kind at widths around
    the block, with duplicate runs, the sentinel and, for floats, NaN,
    +-0.0 and subnormals."""
    rng = np.random.default_rng(9)
    if dtype == np.int64:
        big = np.iinfo(np.int64)
        keys = np.concatenate([[big.min, big.max - 1],
                               rng.integers(-2**40, 2**40, 2_998)])
        q = np.concatenate([rng.integers(-2**41, 2**41, 700),
                            [big.min, big.max, big.max - 1, 0]])
    else:
        keys = np.concatenate([[0.0, -0.0, 5e-324, -5e-324, 1e-310],
                               rng.normal(size=2_995) * 1e3])
        q = np.concatenate([rng.normal(size=700) * 1e3,
                            [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324,
                             1e-310, -1e-311]])
    keys = np.sort(keys.astype(dtype))
    keys[1::7] = keys[::7][:keys[1::7].size]
    keys = np.sort(keys)
    q = np.concatenate([q, keys[::5]]).astype(dtype)
    qt, want = torch.from_numpy(q), rank_of(keys, q)
    for cut in (1, 8, 64):
        b = pt_sorted.build(keys, linear_cutoff=cut, device="cpu")
        same(fs.flat_binary(b.keys_pad, qt, n_pad=b.n_pad, cutoff=cut,
                            n=b.n, stage=stage_of(b)), want, f"binary c{cut}")
    for w, intra in ((1, "vector"), (7, "vector"), (8, "vector"),
                     (9, "vector"), (127, "vector"), (128, "binary")):
        c = pt_css.build(keys, node_width=w, intra=intra, device="cpu")
        same(pt_css.search(c, qt), want, f"css w{w} {intra}")
    for w in (8, 127):
        k = pt_kary.build(keys, node_width=w, device="cpu")
        same(pt_kary.search(k, qt), want, f"kary w{w}")
    for w, pd in ((7, 1), (9, 2)):
        f = pt_fast.build(keys, node_width=w, page_depth=pd, device="cpu")
        same(pt_fast.search(f, qt), want, f"fast w{w} pd{pd}")


# -------------------------------------------------------- wrapper surface
def test_group_lanes_and_tables_are_cached():
    # csb_search reads a node by whole 16-byte pieces, no lane group: a
    # staged row of w keys is padded to them, a stage's links to one more
    assert [fs.csb_stage_bytes(n, 32) for n in (0, 1, 4, 5, 406)] == \
        [0, 48, 144, 192, 14_624]
    a = fs.level_descent("css", (0, 128, 16_640), 128)
    assert a is fs.level_descent("css", (0, 128, 16_640), 128)
    assert all(x.dtype == np.int32 and x.flags.c_contiguous
               for x in a.arrays)
    assert [list(x) for x in a.arrays] == [[0, 1, 130], [1, 1, 1], [0, 0, 0]]
    with pytest.raises(ValueError, match="multiple of w"):
        fs.level_descent("kary", (0, 5), 4)
    with pytest.raises(ValueError, match="levels"):
        fs.level_descent("kary", tuple(range(0, 65 * 4, 4)), 4)


def test_wrappers_take_zero_queries_and_refuse_other_devices():
    keys = np.arange(0, 300, 3, dtype=np.int32)
    c = pt_css.build(keys, node_width=4, device="cpu")
    d = pt_css.descent_args(c)
    empty = torch.zeros(0, dtype=torch.int32)
    assert fs.flat_descent(empty, c.dir_keys, d, c.leaf_pad, c.leaf_width,
                           ending="leaf", n=c.n,
                           stage=stage_of(c)).shape == (0,)
    b = pt_sorted.build(keys, device="cpu")
    assert fs.flat_binary(b.keys_pad, empty, n_pad=b.n_pad, cutoff=1,
                          n=b.n, stage=stage_of(b)).shape == (0,)
    t = pt_csb.CSBTree.build(keys, device="cpu")
    assert t.search(empty).dtype == torch.bool
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fs.flat_descent(meta, c.dir_keys, d, c.leaf_pad, c.leaf_width,
                        ending="leaf", n=c.n, stage=stage_of(c))
    with pytest.raises(ValueError, match="unsupported device"):
        fs.flat_binary(b.keys_pad, meta, n_pad=b.n_pad, cutoff=1, n=b.n,
                       stage=stage_of(b))
    with pytest.raises(ValueError, match="unknown ending"):
        fs.flat_descent(empty, c.dir_keys, d, ending="bogus",
                        stage=stage_of(c))
    # an index built on the CPU holds no stage (its search runs the plain
    # composition); a wrapper handed none says so before anything else
    assert c.stage is None and b.stage is None
    with pytest.raises(ValueError, match="needs the index's DescentStage"):
        fs.flat_descent(meta, c.dir_keys, d, c.leaf_pad, c.leaf_width,
                        ending="leaf", n=c.n, stage=None)
    with pytest.raises(ValueError, match="needs the array's BinaryStage"):
        fs.flat_binary(b.keys_pad, meta, n_pad=b.n_pad, cutoff=1, n=b.n,
                       stage=None)
    before = (fs.flat_binary.launches, fs.flat_descent.launches,
              fs.csb_search.launches)
    pt_css.search(c, keys)                  # the CPU runs the plain version
    assert (fs.flat_binary.launches, fs.flat_descent.launches,
            fs.csb_search.launches) == before
