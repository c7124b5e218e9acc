"""The readers of the valid-work rooflines: on a timeline made by hand they
give the frozen model at the valid counts the program recorded, read only
the store's last `timeline.calls` records, and give None where the program
keeps no store, where there is no timeline, or where the stretch holds more
calls than the store."""

import sys

import pytest
import torch

import saccot_tpu_torch.engine.sac_cot as sac_cot
from regbench import roofline, trace
from regbench.harness import load_reader

READERS = ("valid_degrees_roofline", "valid_pool_roofline", "valid_score_roofline")
PARAMS = {"num_anchors": 256, "neighbors_per_anchor": 16, "max_hypotheses": 2048}
# Two calls of two pairs; an older call of other counts stays in the store.
OLD, CALLS = [[5000, 5000]], [[1500, 2500], [1000, 2200]]


def _timeline():
    # Each kernel runs once a call: 1 + 0.5 s of degrees, 2 s of the fused
    # anchor kernel, 0.25 s of scores; plus a torch kernel no reader reads.
    device = []
    for c in range(2):
        t = 10.0 * c
        device += [(t + 0.0, t + 0.5, "void (anonymous namespace)::tri_degrees_kernel<true>(x)"),
                   (t + 0.5, t + 0.75, "void (anonymous namespace)::degree_sum_kernel<float>(x)"),
                   (t + 1.0, t + 3.0, "(anonymous namespace)::anchor_topb_kernel(float const*)"),
                   (t + 3.0, t + 3.125, "void (anonymous namespace)::score_kernel<false, true>()"),
                   (t + 4.0, t + 5.0, "void at::native::elementwise_kernel<128>()")]
    return trace.reduce(device, [], [(0.0, 9.0), (10.0, 19.0)])


class Ctx:
    params = PARAMS
    timeline = _timeline()


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(sac_cot, "VALID_COUNTS", type(sac_cot.VALID_COUNTS)(
        [sac_cot.ValidCounts(torch.tensor(c), False) for c in OLD + CALLS],
        maxlen=sac_cot.VALID_COUNTS_KEPT))
    return sac_cot.VALID_COUNTS


def _share(model, seconds):
    work = {"flops": 0.0, "bytes": 0.0}
    for n in [n for call in CALLS for n in call]:
        m = model(n)
        work = {k: work[k] + m[k] for k in work}
    return 100.0 * roofline.bound_seconds(work) / seconds


def test_each_reader_gives_the_frozen_model_at_the_recorded_counts(store):
    got = {name: load_reader("metrics", name).read(Ctx) for name in READERS}
    assert got["valid_degrees_roofline"] == pytest.approx(
        _share(roofline.compat_degrees_model, 2 * 0.75))
    assert got["valid_pool_roofline"] == pytest.approx(
        _share(lambda n: roofline.pool_model(n, 256, 16), 2 * 2.0))
    assert got["valid_score_roofline"] == pytest.approx(
        _share(lambda n: roofline.scoring_model(n, 2048), 2 * 0.125))
    # The padded count would read higher: the older call is not the stretch's.
    assert got["valid_score_roofline"] < _share(
        lambda n: roofline.scoring_model(5000, 2048), 2 * 0.125)


def test_the_readers_read_the_last_calls_only(store):
    before = load_reader("metrics", "valid_score_roofline").read(Ctx)
    store.appendleft(sac_cot.ValidCounts(torch.tensor([1, 1]), False))
    assert load_reader("metrics", "valid_score_roofline").read(Ctx) == before
    store.append(sac_cot.ValidCounts(torch.tensor([2500, 2500]), False))
    assert load_reader("metrics", "valid_score_roofline").read(Ctx) != before


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_store_a_timeline_or_enough_records(name, store, monkeypatch):
    reader = load_reader("metrics", name)

    class NoTimeline:
        params, timeline = PARAMS, None
    assert reader.read(NoTimeline) is None
    store.clear()
    store.append(sac_cot.ValidCounts(torch.tensor(CALLS[0]), False))
    assert reader.read(Ctx) is None
    # The program before its store: the name cannot be imported.
    monkeypatch.delattr("saccot_tpu_torch.engine.sac_cot.VALID_COUNTS")
    assert reader.read(Ctx) is None
    monkeypatch.setitem(sys.modules, "saccot_tpu_torch.engine.sac_cot", None)
    assert reader.read(Ctx) is None


def test_a_shard_s_counts_are_not_read(store):
    store.append(sac_cot.ValidCounts(torch.tensor([2500, 2500]), True))
    assert load_reader("metrics", "valid_degrees_roofline").read(Ctx) is None
