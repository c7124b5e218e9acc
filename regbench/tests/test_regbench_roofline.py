"""The frozen yardstick gives the port's kernel-table bounds, and the trace
arithmetic the per-layer readers use is right on intervals made by hand."""

import pytest

from regbench import roofline, trace


def _ms(model):
    return roofline.bound_seconds(model) * 1e3


def test_frozen_bounds_are_the_kernel_table_s():
    # PERF.md section 6: row 1 at the bench point (N=1,000, B=128), rows 5
    # and 4 at the kitti point (N=50,000, two pairs, K=2,048).
    assert _ms(roofline.compat_degrees_model(1000, 128)) == pytest.approx(0.0784, abs=5e-5)
    assert _ms(roofline.compat_degrees_model(50000, 2)) == pytest.approx(3.0638, abs=5e-5)
    assert _ms(roofline.scoring_model(50000, 2048, 2)) == pytest.approx(0.1714, abs=5e-5)
    # Row 6 (the streamed anchor rows) and row 3 (the solve at the bench point).
    assert _ms(roofline.anchor_rows_model(50000, 512, 16, 2)) == pytest.approx(0.0627, abs=5e-5)
    assert _ms(roofline.solve_model(1000, 1024, 128)) == pytest.approx(0.0037, abs=5e-5)


def _tl():
    # Two calls in [0, 10] s: four kernels and a copy; idle [0, 0.5], [4, 5]
    # and [8, 9].
    device = [(0.5, 2.0, "void (anonymous namespace)::tri_degrees_kernel<true>(float*)"),
              (2.0, 4.0, "void (anonymous namespace)::degree_sum_kernel<float>(float*)"),
              (5.0, 7.0, "void score_kernel<false, false>(float const*)"),
              (6.5, 8.0, "void at::native::elementwise_kernel<128>()"),
              (9.0, 10.0, "Memcpy DtoH (Device -> Pinned)")]
    host = [(0.0, 4.5, "aten::sort"), (4.2, 4.4, "aten::sort/cudaLaunchKernel"),
            (7.9, 8.5, "cudaEventSynchronize")]
    return trace.reduce(device, host, [(0.0, 5.0), (5.0, 9.5)])


def test_timeline_busy_idle_and_gaps():
    tl = _tl()
    assert tl.calls == 2 and tl.window_s == pytest.approx(10.0)
    assert tl.busy_s == pytest.approx(7.5)
    assert tl.launches() == 4      # the copy is no kernel
    assert tl.top_gaps() == [["aten::sort", pytest.approx(1.5)],
                             ["cudaEventSynchronize", pytest.approx(1.0)]]
    assert tl.top_ops(1)[0][1] == pytest.approx(2.0)
    assert tl.seconds_of(["tri_degrees_kernel", "degree_sum_kernel"]) == (pytest.approx(3.5), 2)
    # A whole word only: "score_kernel" is not "xscore_kernel".
    assert tl.seconds_of(["core_kernel"]) == (0.0, 0)


def test_no_stretch_without_calls_or_device_work():
    assert trace.reduce([], [], [(0.0, 1.0)]) is None
    assert trace.reduce([(0.0, 1.0, "k")], [], []) is None


def test_stage_share_counts_every_launch_of_the_stage():
    tl = _tl()
    work = {"flops": roofline.PEAKS.fp32_instructions_per_s * 0.7, "bytes": 0.0}
    # Two launches' bounds of 0.7 s each would be 1.4 s over 3.5 s; one is
    # the tile sum, counted by the first kernel's model.
    share = roofline.stage_share(tl, {"tri_degrees_kernel": work, "degree_sum_kernel": None})
    assert share == pytest.approx(100 * 0.7 / 3.5)
    assert roofline.stage_share(tl, {"anchor_topb_kernel": work}) is None


def test_device_idle_and_launch_readers():
    from regbench.harness import load_reader

    class Ctx:
        timeline = _tl()
    assert load_reader("metrics", "device_idle").read(Ctx) == pytest.approx(25.0)
    assert load_reader("metrics", "launches_per_call").read(Ctx) == pytest.approx(2.0)
    # glue: every kernel no stage names (the elementwise one), ms a call.
    assert load_reader("metrics", "glue_ms").read(Ctx) == pytest.approx(1e3 * 1.5 / 2)
    # The kernels glue_ms leaves out are fixed in its own file.
    assert {"tri_degrees_kernel", "score_kernel", "solve3_kernel",
            "anchor_topb_stream_kernel"} <= set(load_reader("metrics", "glue_ms").STAGED)
