"""The port's sort-and-bucket schedule against the reference's.

Plans must be bit-identical: the torch device plan (sort and histogram
constructions) against the reference's jnp device plan and its numpy host
plan, the ladder arithmetic, the plan-method thresholds, and the
static-grid early-exit form of ``run_scheduled`` against the reference's
rung-selected one. Inputs are made with numpy from a seed; everything runs
on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import schedule as ref
from repro.kernels import page_search as ref_page

from repro_torch.engine import schedule as pt
from repro_torch.kernels import page_search as pt_page

torch.set_num_threads(1)

PATTERNS = ["uniform", "zipf", "dups", "single"]
# the device plan's run starts at their edges: runs of one lane, of a
# tile, and one lane either side of one, two and three tiles (in request
# order shuffled); only page 0 and page P-1; a batch one lane past a whole
# number of tiles, and one of whole tiles
PLAN_PATTERNS = PATTERNS + ["long_runs", "ends", "tail", "whole"]
PLAN_Q = {"tail": 64 * 37 + 1, "whole": 64 * 40}     # else 3000
RUNS = [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 2]


def page_batch(pattern, q_n=3000, num_pages=41, seed=17):
    rng = np.random.default_rng(seed)
    if pattern == "long_runs":
        counts = RUNS + [q_n - sum(RUNS)]
        pages = rng.choice(num_pages, len(counts), replace=False)
        return rng.permutation(np.repeat(pages, counts)).astype(np.int32)
    return {
        "uniform": rng.integers(0, num_pages, q_n),
        "zipf": np.minimum(rng.zipf(1.3, q_n) - 1, num_pages - 1),
        "dups": rng.integers(0, 4, q_n),
        "single": np.full(q_n, 7),
        "ends": rng.choice([0, num_pages - 1], q_n),
        "tail": rng.integers(0, num_pages, q_n),
        "whole": rng.integers(0, 3, q_n),
    }[pattern].astype(np.int32)


@pytest.mark.parametrize("method", ["sort", "histogram"])
@pytest.mark.parametrize("pattern", PLAN_PATTERNS)
def test_device_plan_matches_reference(pattern, method):
    q_n, num_pages, tile = PLAN_Q.get(pattern, 3000), 41, 64
    page_of = page_batch(pattern, q_n, num_pages)
    cap = pt.ladder_grid(q_n, tile, num_pages)
    assert cap == ref.ladder_grid(q_n, tile, num_pages)
    want = ref.device_plan(jnp.asarray(page_of), tile, cap, num_pages,
                           method=method)
    got = pt.device_plan(torch.from_numpy(page_of), tile, cap, num_pages,
                         method=method)
    assert got.dest.dtype == got.step_pages.dtype == torch.int32
    np.testing.assert_array_equal(got.dest.numpy(), np.asarray(want.dest))
    np.testing.assert_array_equal(got.step_pages.numpy(),
                                  np.asarray(want.step_pages))
    assert int(got.steps_used) == int(want.steps_used)

    # through lane_arrays, against the reference's and the host plan
    gather, valid = (a.numpy() for a in pt.lane_arrays(got, tile))
    r_gather, r_valid = (np.asarray(a) for a in ref.lane_arrays(want, tile))
    np.testing.assert_array_equal(gather, r_gather)
    np.testing.assert_array_equal(valid, r_valid)
    host = pt.bucket_plan(page_of, tile)
    L = host.grid * tile
    assert int(got.steps_used) == host.steps_used
    np.testing.assert_array_equal(valid[:L], host.valid)
    assert not valid[L:].any()
    np.testing.assert_array_equal(gather[:L][host.valid],
                                  host.gather[host.valid])


@pytest.mark.parametrize("pattern", PATTERNS + ["empty"])
def test_bucket_plan_matches_reference(pattern):
    page_of = (np.zeros(0, np.int32) if pattern == "empty"
               else page_batch(pattern, 700, 23, seed=3))
    got, want = pt.bucket_plan(page_of, 32), ref.bucket_plan(page_of, 32)
    for f in ("gather", "valid", "step_pages"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.grid, got.steps_used, got.occupancy) == \
        (want.grid, want.steps_used, want.occupancy)


def test_device_plan_empty_batch():
    got = pt.device_plan(torch.zeros(0, dtype=torch.int32), 128,
                         pt.ladder_grid(0, 128, 9), 9)
    assert got.dest.shape == (0,) and got.step_pages.shape == (1,)
    assert int(got.steps_used) == 0


def test_ladder_arithmetic_matches_reference():
    rng = np.random.default_rng(23)
    for _ in range(300):
        q_n = int(rng.integers(0, 1 << 21))
        num_pages = int(rng.integers(1, 20000))
        tile = int(rng.choice([8, 32, 128]))
        assert pt.worst_case_steps(q_n, tile, num_pages) == \
            ref.worst_case_steps(q_n, tile, num_pages)
        assert pt.ladder_for(q_n, tile, num_pages) == \
            ref.ladder_for(q_n, tile, num_pages)
        g_cap = pt.ladder_grid(q_n, tile, num_pages)
        assert pt.ladder_rungs(q_n, tile, g_cap) == \
            ref.ladder_rungs(q_n, tile, g_cap)
        used = int(rng.integers(0, max(g_cap, 1) + 1))
        assert pt.executed_occupancy(q_n, used, tile, num_pages) == \
            ref.executed_occupancy(q_n, used, tile, num_pages)
    counts = {"a": 3, "b": 0, "c": 9}
    assert pt.occupancy_shares(counts, 0.7) == ref.occupancy_shares(counts,
                                                                    0.7)
    assert pt.occupancy_shares({"a": 0}, 0.5) == {"a": 0.0}


def test_plan_method_and_thresholds_match_reference():
    cells = [(0, 4), (4096, 4), (4096, 32), (4096, 33), (8192, 64),
             (100000, 32), (4095, 1), (5000, None)]
    assert [pt.plan_method(q, p) for q, p in cells] == \
        [ref.plan_method(q, p) for q, p in cells]
    with pt.plan_thresholds(max_pages=64, min_queries=8, min_depth=2):
        assert pt.plan_method(128, 64) == "histogram"
    assert pt.plan_method(128, 64) == "sort"              # restored
    with pytest.raises(ValueError, match="max_pages"):
        pt.set_plan_thresholds(max_pages=0)
    with pytest.raises(ValueError, match="unknown plan method"):
        pt.device_plan(torch.zeros(4, dtype=torch.int32), 8, 4, 4,
                       method="bogus")
    with pytest.raises(ValueError, match="needs num_pages"):
        pt.device_plan(torch.zeros(4, dtype=torch.int32), 8, 4,
                       method="histogram")


def _pages(num_pages, lw_pad, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 10**6, num_pages * lw_pad)).astype(np.int32)
    return keys.reshape(num_pages, lw_pad)


@pytest.mark.parametrize("pattern", ["uniform", "zipf", "single"])
def test_run_scheduled_early_exit_matches_reference(pattern):
    """The static grid with blocks past steps_used left undefined gives the
    reference's rung-selected outputs, lane for lane."""
    num_pages, tile, q_n = 16, 32, 600
    pages = _pages(num_pages, 128, seed=1)
    rng = np.random.default_rng(2)
    page_of = page_batch(pattern, q_n, num_pages, seed=4)
    q = pages[page_of, rng.integers(0, 128, q_n)] + 1
    g_cap = pt.ladder_grid(q_n, tile, num_pages)

    want = np.asarray(ref.run_scheduled(
        ref.device_plan(jnp.asarray(page_of), tile, g_cap, num_pages),
        jnp.asarray(q), q_n, tile, g_cap,
        lambda qb, sp, g: ref_page.page_search_bucketed(
            qb, sp, jnp.asarray(pages), stride=128, interpret=True)))

    def body(qb, step_pages, steps_used):
        out = pt_page.page_search_bucketed(qb, step_pages,
                                           torch.from_numpy(pages),
                                           stride=128, steps_used=steps_used)
        out[int(steps_used):] = -7          # what the kernel leaves undefined
        return out

    plan = pt.device_plan(torch.from_numpy(page_of), tile, g_cap, num_pages)
    got = pt.run_scheduled(plan, torch.from_numpy(q), tile, g_cap, body)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(pages.reshape(-1), q, side="left"))


def test_run_scheduled_multi_two_operands():
    num_pages, tile, q_n = 8, 16, 300
    page_of = page_batch("zipf", q_n, num_pages, seed=8)
    a = np.arange(q_n, dtype=np.int32) * 3
    b = np.linspace(-1, 1, q_n, dtype=np.float32)
    g_cap = pt.ladder_grid(q_n, tile, num_pages)
    plan = pt.device_plan(torch.from_numpy(page_of), tile, g_cap, num_pages)
    out_a, out_b = pt.run_scheduled_multi(
        plan, (torch.from_numpy(a), torch.from_numpy(b)), tile, g_cap,
        lambda qbs, sp, used: (qbs[0] + sp[:, None], qbs[1] * 2))
    np.testing.assert_array_equal(out_a.numpy(), a + page_of)
    np.testing.assert_array_equal(out_b.numpy(), b * 2)
