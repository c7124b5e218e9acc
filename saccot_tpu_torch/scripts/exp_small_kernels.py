"""Time the candidate top-T and solve kernels under every plan of their sweeps,
beside the card's launch floor.

    python -m saccot_tpu_torch.scripts.exp_small_kernels [reps] [--solve-only]

First the launch floor: the device ms of an empty kernel launched as one
thread (`utils.profile.launch_floor_ms`). Then:
  - the candidate top-T (`csrc/candidate_topt.cu`) with W anchors a block, W
    in {1, 2, 4, 8}, on the streamed selections at the kitti point (2 x 512
    anchors, B=16, T=4, N=50,000) and its anchor shard (the first 256
    anchors); every W must give `candidate_plan`'s bits, and at N=3,000 the
    fused kernel's top-T mode's, with and without masks (left out with
    --solve-only);
  - the solve (`csrc/solve3.cu`) in blocks of {32, 64, 128, 256} threads on
    the pools of the kitti (2 x 2,048 hypotheses, N=50,000), 3DMatch (32 x
    2,048, N=2,048) and bench (128 x 1,024, N=1,000) points; every plan must
    give `solve3_reference`'s bits; then, where blocks of 256 cover the
    SMs, blocks of 128 against blocks of 256 in 10 pairs, alternating which
    runs first.
For each plan it prints the kernel's device ms (`utils.profile.
kernel_device_ms` over `reps` calls), that over the floor, and the
CUDA-event ms per call around `reps` calls issued back to back (the
wrapper's host work included); then what ptxas reported for both kernels
(registers, shared memory, spills), the solve's SASS (`cuobjdump`: its
instructions, FP32 and MUFU among them, and the instructions a hypothesis
runs) and the SM clock. Exits 1 at the first plan whose bits differ. Needs
a CUDA device.
"""

from __future__ import annotations

import collections
import subprocess
import sys

import numpy as np
import torch

from saccot_tpu_torch.engine import triangles as tri_mod
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import solve3 as ksolve
from saccot_tpu_torch.kernels import triangles as ktri
from saccot_tpu_torch.scripts.exp_compat_ops import sass_functions
from saccot_tpu_torch.scripts.exp_degree_plan import back_to_back_ms
from saccot_tpu_torch.utils.convert import (
    KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch,
)
from saccot_tpu_torch.utils.params import SacCotParams
from saccot_tpu_torch.utils.profile import kernel_device_ms, launch_floor_ms

CANDIDATE_WARPS = (1, 2, 4, 8)
SOLVE_THREADS = (32, 64, 128, 256)
PAIRS = 10    # paired readings of blocks of 128 and of 256 at each point
TOP_T = 4
BENCH = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=256,
                     neighbors_per_anchor=12, max_hypotheses=1024)
TDM = SacCotParams(compat_tau=0.05, min_separation=0.1, inlier_tau=0.05, num_anchors=256,
                   neighbors_per_anchor=16, max_hypotheses=2048)


def candidate_plans(batch: int, A: int, B: int):
    """Every W of the sweep as a grid of the shape."""
    return [ktri.make_candidate_plan(batch, A, B, w) for w in CANDIDATE_WARPS]


def solve_plans(batch: int, K: int):
    """Every block size of the sweep as a grid of the shape."""
    return [ksolve.make_solve_plan(batch, K, threads) for threads in SOLVE_THREADS]


def solve_points(dev):
    """(name, P, Q, params) of the three points the solve is swept at."""
    PK, QK, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev)
    P3, Q3, _ = problem_batch(range(300, 332), device=dev, n=2048, outlier_ratio=0.9,
                              noise=0.01)
    PB, QB, _ = problem_batch(range(1000, 1128), device=dev, n=1000, outlier_ratio=0.8,
                              noise=0.004)
    return [("kitti", PK, QK, KITTI_PARAMS), ("3DMatch", P3, Q3, TDM), ("bench", PB, QB, BENCH)]


def _timed(call, reps: int, floor: float) -> str:
    ms = kernel_device_ms(call, reps)
    return (f"device {ms:.4f} ms ({ms / floor:.2f} x floor), "
            f"events {back_to_back_ms(call, reps):.4f} ms")


def sweep_candidates(dev, reps: int, floor: float) -> bool:
    kp = KITTI_PARAMS
    B, tau, sep = kp.neighbors_per_anchor, kp.compat_tau, kp.min_separation
    # N=3,000: every W against the fused kernel's top-T mode, with and
    # without masks.
    P3, Q3, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev, n=3000)
    anc3 = ktri.topk_stable(kcompat.degrees(P3, Q3, P3, Q3, kp), kp.num_anchors)[1]
    m3 = (torch.arange(3000, device=dev) % 7 != 3).float().expand(2, 3000).contiguous()
    for kw in ({}, dict(mask=m3, anchor_mask=torch.gather(m3, 1, anc3))):
        fused = ktri.anchor_neighbors(P3, Q3, anc3, B, tau, sep, **kw, top_t=TOP_T)
        for plan in candidate_plans(2, kp.num_anchors, B):
            got = ktri._candidate(fused[0], fused[1], P3, Q3, TOP_T, tau, sep, plan)
            if not all(torch.equal(x, y) for x, y in zip(got, fused[2:])):
                print(f"candidate_topt warps={plan.warps} mask={bool(kw)}: BITS DIFFER from the "
                      "fused top-T mode at N=3000", flush=True)
                return False
    print("candidate_topt at N=3000: every W bit-identical to the fused top-T mode, with and "
          "without masks", flush=True)
    PK, QK, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev)
    anchors = ktri.topk_stable(kcompat.degrees(PK, QK, PK, QK, kp), kp.num_anchors)[1]
    nbr_s, nbr_idx = ktri.anchor_neighbors_stream(PK, QK, anchors, B, tau, sep)
    for name, A in (("kitti", kp.num_anchors), ("anchor shard", kp.num_anchors // 2)):
        sel = (nbr_s[:, :A].contiguous(), nbr_idx[:, :A].contiguous(), PK, QK, TOP_T, tau, sep)
        chosen = ktri.candidate_plan(2, A, B)
        want = ktri._candidate(*sel, chosen)
        print(f"candidate_topt at {name} (2 x {A} anchors, B={B}, T={TOP_T}): candidate_plan "
              f"warps={chosen.warps}", flush=True)
        for plan in candidate_plans(2, A, B):
            if not all(torch.equal(x, y) for x, y in zip(ktri._candidate(*sel, plan), want)):
                print(f"  warps={plan.warps}: BITS DIFFER", flush=True)
                return False
            print(f"  warps={plan.warps} blocks={plan.blocks:4d} smem={plan.smem_bytes:5d}: "
                  f"{_timed(lambda: ktri._candidate(*sel, plan), reps, floor)}", flush=True)
    return True


def sweep_solve(dev, reps: int, floor: float) -> bool:
    sms = kcompat.sm_count(dev)
    for name, P, Q, params in solve_points(dev):
        deg = kcompat.degrees(P, Q, P, Q, params)
        triples = tri_mod.triangle_pool_from_points(P, Q, deg, params).triples
        batch, K = triples.shape[:2]
        want = ksolve.solve3_reference(P, Q, triples)
        chosen = ksolve.solve_plan(batch, K, sms)
        print(f"solve3 at {name} ({batch} x {K} hypotheses, N={P.shape[1]}): solve_plan "
              f"threads={chosen.threads} ({sms} SMs)", flush=True)
        for plan in solve_plans(batch, K):
            if not all(torch.equal(x, y) for x, y in zip(ksolve._solve(P, Q, triples, plan),
                                                        want)):
                print(f"  threads={plan.threads}: BITS DIFFER from solve3_reference", flush=True)
                return False
            print(f"  threads={plan.threads:3d} blocks={plan.blocks:5d}: "
                  f"{_timed(lambda: ksolve._solve(P, Q, triples, plan), reps, floor)}",
                  flush=True)
        if ksolve.make_solve_plan(batch, K, ksolve.THREADS).blocks >= sms:
            mid, big = (ksolve.make_solve_plan(batch, K, t)
                        for t in (ksolve.MID_THREADS, ksolve.THREADS))
            print_pairs(lambda: ksolve._solve(P, Q, triples, mid),
                        lambda: ksolve._solve(P, Q, triples, big), reps)
    return True


def print_pairs(mid, big, reps: int, pairs: int = PAIRS) -> None:
    """Blocks of MID_THREADS against blocks of THREADS: device ms of each
    (`kernel_device_ms` over `reps` calls) in `pairs` pairs, which side runs
    first alternating; each side's median and quartiles, and the pairs
    each wins."""
    ms = {ksolve.MID_THREADS: [], ksolve.THREADS: []}
    for i in range(pairs):
        order = ((ksolve.MID_THREADS, mid), (ksolve.THREADS, big))
        for threads, fn in order if i % 2 == 0 else order[::-1]:
            ms[threads].append(kernel_device_ms(fn, reps))
    wins = sum(b < m for m, b in zip(ms[ksolve.MID_THREADS], ms[ksolve.THREADS]))
    stats = {threads: [round(float(q), 5) for q in np.quantile(v, [0.25, 0.5, 0.75])]
             for threads, v in ms.items()}
    print(f"  paired, {pairs} pairs: quartile/median/quartile ms by threads a block {stats}; "
          f"blocks of {ksolve.THREADS} lower in {wins}", flush=True)


def print_solve_sass() -> None:
    """The solve kernel as compiled: instructions, FP32 (F*) and MUFU among
    them, and the instructions a hypothesis runs, from entry to the last
    EXIT (the roots' and reciprocals' slow paths, never taken here, sit
    after it)."""
    for fn, instrs in sorted(sass_functions("solve3_kernel").items()):
        ops = collections.Counter(op for _, op, _ in instrs)
        fp32 = sum(v for op, v in ops.items() if op.startswith("F"))
        mufu = sum(v for op, v in ops.items() if op.startswith("MUFU"))
        path = 1 + max(i for i, (_, op, _) in enumerate(instrs) if op == "EXIT")
        print(f"  sass solve3: {sum(ops.values())} instructions, {fp32} FP32, {mufu} MUFU; a "
              f"hypothesis {path}; top {ops.most_common(10)}", flush=True)


def sm_clock_mhz(cycles: int = 2_000_000) -> float:
    """The SM clock while the card is busy: `torch.cuda._sleep(cycles)` (a
    kernel that spins for `cycles` clocks) over its CUDA-event time."""
    torch.cuda._sleep(cycles)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    stop.synchronize()
    return cycles / (start.elapsed_time(stop) * 1e3)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    solve_only = "--solve-only" in argv
    argv = [a for a in argv if a != "--solve-only"]
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        print("exp_small_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi.stdout.strip()}")
    floors = [launch_floor_ms(reps) for _ in range(3)]
    floor = min(floors)
    print(f"launch floor (an empty kernel, one thread): device {floors} ms", flush=True)
    if not ((solve_only or sweep_candidates(dev, reps, floor)) and sweep_solve(dev, reps, floor)):
        return 1
    source = None
    for line in _build.build_log.splitlines():
        source = line[3:] if line.startswith("== ") else source
        if source in ("candidate_topt.cu", "solve3.cu") and (
                "registers" in line or "stack frame" in line or "Compiling entry" in line):
            print(f"  ptxas ({source}):", line.split("ptxas info    :")[-1].strip()[:160])
    print_solve_sass()
    print(f"SM clock (a spin of 2e6 cycles over its event time): "
          f"{[round(sm_clock_mhz(), 1) for _ in range(3)]} MHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
