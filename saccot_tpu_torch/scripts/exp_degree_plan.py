"""Time the two-sided degree loop under other launch plans than `degree_plan`'s.

    python -m saccot_tpu_torch.scripts.exp_degree_plan [reps]

At the shapes the port gives the loop (the ring step at kitti with two ranks,
2 x 25,000 x 25,000; the 3DMatch point's SP slice, 32 x 1,024 x 2,048; the
bench point, 128 x 1,000 x 1,000; one pair at N=50,000), it launches
`csrc/compat_degrees.cu` on each plan of a grid of rows a thread and column
splits, checks that every plan gives the bits of `degree_plan`'s (the sum
order depends on C alone), and prints the device ms per launch: CUDA events
around `reps` launches issued back to back, over `reps`. Then the registers
and spills ptxas reported for each instance of the loop. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch

# (name, batch, rows R, columns C): each shape's rows are the first R points.
SHAPES = [("ring step", 2, 25000, 25000), ("SP slice", 32, 1024, 2048),
          ("bench", 128, 1000, 1000), ("attribution", 1, 50000, 50000)]
ROWS = kcompat.ROWS_PER_THREAD


def back_to_back_ms(fn, reps: int) -> float:
    """Device ms per call: events around `reps` calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def plans(batch: int, R: int, C: int):
    """Each rows a thread with 1, 2, 4, ... splits up to one a segment."""
    segments = -(-C // kcompat.SEGMENT)
    for rows in ROWS:
        tiles = -(-R // (kcompat.THREADS * rows))
        splits, out = 1, []
        while splits < segments:
            out.append(splits)
            splits *= 2
        out.append(segments)
        for s in out:
            yield kcompat.DegreePlan(batch=batch, rows=rows, tiles=tiles, splits=s,
                                     segments=segments)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        print("exp_degree_plan: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi.stdout.strip()}")
    sms = kcompat.sm_count(dev)
    for name, batch, R, C in SHAPES:
        P, Q, _ = kitti_problem_batch(range(KITTI_SEED, KITTI_SEED + batch), device=dev, n=C)
        args = (P[:, :R].contiguous(), Q[:, :R].contiguous(), P, Q, KITTI_PARAMS, 0, None, None,
                "compat_degrees")
        chosen = kcompat.degree_plan(batch, R, C, sms)
        want = kcompat._two_sided(*args, plan=chosen)
        print(f"{name} ({batch} x {R} x {C}): degree_plan rows={chosen.rows} "
              f"splits={chosen.splits}, {chosen.blocks} blocks")
        for plan in plans(batch, R, C):
            got = kcompat._two_sided(*args, plan=plan)
            same = torch.equal(got, want)
            ms = back_to_back_ms(lambda: kcompat._two_sided(*args, plan=plan), reps)
            print(f"  rows={plan.rows} splits={plan.splits:3d} blocks={plan.blocks:6d}: "
                  f"{ms:.4f} ms{'' if same else '  BITS DIFFER'}", flush=True)
            if not same:
                return 1
    for line in _build.build_log.splitlines():
        if "two_sided_degrees_kernel" in line or "registers" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip()[:160])
    return 0


if __name__ == "__main__":
    sys.exit(main())
