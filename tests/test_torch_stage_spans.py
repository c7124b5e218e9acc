"""The estimator's stage ranges: every call of `register_batch` runs in the
seven `saccot/<stage>` ranges of `engine/sac_cot.py`, one after the other,
and every torch operation of the call runs inside one of them.
`utils.profile.range_counts` puts each device operation down to the range
that holds the runtime call that launched it, and counts the blocking
runtime calls inside each range."""

import pytest
import torch
from torch.autograd.profiler_util import FunctionEvent

from saccot_tpu_torch.cli.configs import CONFIGS
from saccot_tpu_torch.engine import sac_cot
from saccot_tpu_torch.utils import profile
from saccot_tpu_torch.utils.convert import (
    KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch,
)
from saccot_tpu_torch.utils.params import SacCotParams
from saccot_tpu_torch.utils.profiling import profiler

STAGES = ("degrees", "pool", "solve", "score", "select", "refine", "result")
PARAMS = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=16,
                      neighbors_per_anchor=8, max_hypotheses=64)
CPU = torch.autograd.DeviceType.CPU


def _host(events, thread):
    return [e for e in events if e.device_type == CPU and e.thread == thread]


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_each_call_runs_in_the_seven_stage_ranges(impl):
    P, Q = problem_batch(range(2), device="cpu", n=200, outlier_ratio=0.5, noise=0.004)[:2]
    calls = 2
    with profiler() as prof:
        for _ in range(calls):
            sac_cot.register_batch(P, Q, PARAMS, impl=impl)
    events = prof.events()
    spans = sorted((e for e in events if e.device_type == CPU
                    and e.name.startswith(sac_cot.STAGE_PREFIX)),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == [sac_cot.STAGE_PREFIX + s for s in STAGES] * calls
    # One after the other: none overlaps the next, so none holds another.
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    thread = spans[0].thread
    assert all(e.thread == thread for e in spans)
    ops = [e for e in _host(events, thread) if e.name.startswith("aten::")]
    assert ops
    for op in ops:
        assert any(s.time_range.start <= op.time_range.start and op.time_range.end
                   <= s.time_range.end for s in spans), op.name
    got = profile.range_ms(prof.key_averages(), sac_cot.STAGE_PREFIX, calls)
    assert {name: row["calls"] for name, row in got.items()} == {s: 1 for s in STAGES}
    assert all(row["host_ms"] > 0.0 for row in got.values())
    # On the CPU nothing is launched on a card and nothing waits for one.
    counts = profile.range_counts(events, sac_cot.STAGE_PREFIX, calls)
    assert counts == {s: dict(device_ms=0.0, device_ops=0.0, syncs=0.0, sync_ms=0.0)
                      for s in STAGES}


def _event(name, start, end, thread=1, corr=0, device=False, annotation=False):
    return FunctionEvent(id=corr, name=name, thread=thread, start_us=start, end_us=end,
                         device_type=torch.autograd.DeviceType.CUDA if device else CPU,
                         is_user_annotation=annotation)


def test_range_counts_follow_the_launch_not_the_name():
    """Synthetic events as the profiler records them. A device operation
    counts in the range that holds the runtime call of the same correlation
    id: the pool's anchor kernel, launched by a ctypes call (which carries
    the OS thread's id), and its pageable copy; a kernel whose name says
    "anchor" that the refine's `aten::mul` launched is the refine's, though
    it ran on the card after the refine's range had ended. A launch from
    another torch thread, the range's own span on the card, and a blocking
    call outside every range (the caller's read-back) count nowhere."""
    events = [
        _event("regbench/call", 0, 100),
        _event("saccot/pool", 10, 40),
        _event("aten::copy_", 12, 30),
        _event("cudaMemcpyAsync", 13, 14, corr=7),
        _event("cudaStreamSynchronize", 14, 29, corr=8),
        _event("cudaLaunchKernel", 31, 32, thread=40321, corr=9),
        _event("saccot/refine", 50, 80),
        _event("aten::mul", 52, 54),
        _event("cudaLaunchKernel", 52.5, 53, corr=10),
        _event("aten::add", 55, 57, thread=2),
        _event("cudaLaunchKernel", 55.5, 56, thread=2, corr=11),
        _event("cudaEventSynchronize", 85, 99, corr=12),
        _event("Memcpy HtoD (Pageable -> Device)", 15, 16, corr=7, device=True),
        _event("anchor_topb_kernel", 33, 38, corr=9, device=True),
        _event("saccot/pool", 15, 38, device=True, annotation=True),
        _event("anchor_elementwise_kernel", 82, 82.5, corr=10, device=True),
        _event("elementwise_kernel", 58, 59, corr=11, device=True),
    ]
    got = profile.range_counts(events, sac_cot.STAGE_PREFIX, 1)
    assert set(got) == {"pool", "refine"}
    assert got["pool"] == pytest.approx(dict(device_ms=0.006, device_ops=2, syncs=1,
                                              sync_ms=0.015))
    assert got["refine"] == pytest.approx(dict(device_ms=0.0005, device_ops=1, syncs=0,
                                                sync_ms=0.0))
    halves = profile.range_counts(events, sac_cot.STAGE_PREFIX, 2)
    assert halves["pool"]["syncs"] == 0.5 and halves["refine"]["device_ops"] == 0.5


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device: it counts waits on the card")
@pytest.mark.parametrize("config", ["kitti", "threedmatch"])
def test_pool_waits_on_nothing_on_card(config):
    """The pool enqueues its whole stage: no blocking runtime call inside
    `saccot/pool`, at N = 50,000 (exact, two pairs) and at the threedmatch
    shape (exact, N = 2,048), where its pair table once came from the host
    by a pageable copy that waited for the card."""
    if config == "kitti":
        P, Q, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1])
        params = KITTI_PARAMS
    else:
        cfg = CONFIGS["threedmatch"]
        P, Q, _ = problem_batch([cfg.seed, cfg.seed + 1], n=cfg.n_corr,
                                outlier_ratio=cfg.outlier_ratio, noise=cfg.noise)
        params = cfg.params
    sac_cot.register_batch(P, Q, params)   # builds the kernels
    torch.cuda.synchronize()
    with profiler() as prof:
        sac_cot.register_batch(P, Q, params)
        torch.cuda.synchronize()
    pool = profile.range_counts(prof.events(), sac_cot.STAGE_PREFIX, 1)["pool"]
    assert pool["device_ops"] > 0
    assert pool["syncs"] == 0, pool
