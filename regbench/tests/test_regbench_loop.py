"""The call loop, the generator and a whole tiny run on the CPU (the plain
route of the program). The command itself refuses to run without a card, so
these call the harness directly."""

import json

import numpy as np
import pytest
import torch

from regbench import compare, generate, harness, loop
from regbench.tests.tiny import plain, tiny_cell


def test_same_seed_same_problems_other_seed_other_problems():
    cell = tiny_cell("kitti.sweep")
    a = generate.cell_batches(2 ** 31 + 11, cell.config, cell.traffic, device="cpu")
    b = generate.cell_batches(2 ** 31 + 11, cell.config, cell.traffic, device="cpu")
    c = generate.cell_batches(12, cell.config, cell.traffic, device="cpu")
    assert len(a) == cell.traffic["distinct_batches"]
    for x, y, z in zip(a, b, c):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) and torch.equal(x[2], y[2])
        assert x[0].shape == z[0].shape == (4, 600, 3) and not torch.equal(x[0], z[0])
        assert x[0].dtype == torch.float32 and x[3] is None
    assert not torch.equal(a[0][0], a[1][0])        # the batches of a run differ


def test_planted_problem_follows_its_configuration():
    cfg = harness.load_cell("kitti.sweep").config
    gen = torch.Generator().manual_seed(3)
    P, Q, T, _ = generate.planted_batch(gen, 2, 4000, cfg["problem"], device="cpu")
    R, t = T[:, :3, :3], T[:, :3, 3]
    assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3, dtype=R.dtype).expand(2, 3, 3))
    resid = torch.linalg.vector_norm(P.double() @ R.transpose(1, 2) + t[:, None] - Q.double(),
                                     dim=-1)
    inliers = (resid < 0.3).double().mean(dim=1)
    # 70% mismatches; a true match is off by the metric noise alone.
    assert torch.all((inliers > 0.27) & (inliers < 0.34))
    assert float(P.abs().max()) > 20.0     # scene scale (30 m)


def test_masked_traffic_keeps_a_prefix_of_each_pair():
    cfg = harness.load_cell("kitti.sweep").config
    gen = torch.Generator().manual_seed(5)
    _, _, _, mask = generate.planted_batch(gen, 8, 1000, cfg["problem"], n_valid=(500, 1000),
                                           device="cpu")
    kept = mask.sum(dim=1)
    assert mask.dtype == torch.bool and torch.all((kept >= 500) & (kept <= 1000))
    assert torch.equal(mask, torch.arange(1000)[None] < kept[:, None])


def test_two_calls_in_flight():

    def call(i):
        return {"x": torch.full((3,), float(i))}

    ticks = iter(range(1000))
    w = loop.run_calls(call, ["x"], 2, 3, count=5, first_index=7,
                       clock=lambda: float(next(ticks)))
    assert [c.index for c in w.calls] == [7, 8, 9, 10, 11]
    assert [float(c.out["x"][0]) for c in w.calls] == [7, 8, 9, 10, 11]
    assert all(c.enqueued < c.returned < c.done for c in w.calls)
    # Call k + 1 is enqueued before call k is read back.
    assert w.calls[0].done > w.calls[1].enqueued
    assert w.pairs == 15 and w.seconds > 0


def test_failed_pairs_counts_misses_and_failures():
    T = np.tile(np.eye(4), (3, 1, 1))
    T[:, :3, 3] = [1.0, 2.0, 3.0]
    good = {"R": np.tile(np.eye(3), (3, 1, 1)), "t": T[:, :3, 3].copy(),
            "success": np.array([True, True, False])}
    bad = dict(good, t=good["t"] + [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.0, 0.0]])
    calls = [loop.CallRecord(0, 0, 0, 0, good), loop.CallRecord(1, 0, 0, 0, bad)]
    # Pair 2 fails in both calls, pair 1 misses 0.3 m in the second.
    assert compare.failed_pairs(calls, [T], {"rot_deg": 5.0, "trans": 0.3}) == 3


def test_sample_spans_the_batch():
    s = compare.draw_sample(2 ** 31 + 3, 10, 32, 8)
    assert len(s) == 8 and all(0 <= c < 10 for c, _ in s)
    assert sorted(p // 8 for _, p in s) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert s == compare.draw_sample(2 ** 31 + 3, 10, 32, 8)


@pytest.mark.parametrize("name", ["kitti.sweep", "threedmatch.sweep"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run(name, traced):
    cell = tiny_cell(name)
    res = harness.run(cell, 2 ** 31 + 7, 0.3, traced, torch.device("cpu"), 0.0,
                      register=plain())
    # On the CPU there is no device trace, so no breakdown either.
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert list(res["compared"]) == compare.compared(cell.spec["limits"])
    assert all(v["value"] == 0.0 for v in res["compared"].values())   # plain is the reference
    expected = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    if traced:
        assert set(res["metrics"]) == {"dispatch_ms"} and "dispatch_ms" in expected
    else:
        assert set(res["metrics"]) == expected
        assert ("pair_ms_p95" in expected) == (name == "kitti.sweep")
    json.dumps(res)
