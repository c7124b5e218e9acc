"""Profile `register_batch` at a named operating point on one GPU.

    python -m saccot_tpu_torch.utils.profile kitti-exact kitti-fast [--reps 5]

For each point it prints one JSON line: the wall ms per batch (host clock
around `--reps` batches ending in `torch.cuda.synchronize()`, after one
warm-up batch), and from `torch.profiler` over `--batches` batches the device
busy ms per batch (the sum of CUDA kernel times; the port runs on one
stream), the idle share 1 - busy / wall, the kernels launched per batch, the
five kernels with the most device time, and the device ms per batch of each
hand-written kernel (`csrc/`). Needs a CUDA device. `kernel_device_ms`
gives the same device ms of the hand-written kernels for any call
(`chip_smoke.py` reads it beside the CUDA-event times of the degree kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time

import torch

from saccot_tpu_torch.engine.sac_cot import register_batch
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch
from saccot_tpu_torch.utils.params import SacCotParams

_BENCH = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=256,
                      neighbors_per_anchor=12, max_hypotheses=1024)
_FAST = dict(dedup_triangles=False, approx_topk=True, per_anchor_candidates=4)


def _bench(params):
    return lambda dev: (problem_batch(range(1000, 1128), device=dev, n=1000, outlier_ratio=0.8,
                                      noise=0.004)[:2], params)


def _kitti(params):
    return lambda dev: (kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev)[:2],
                        params)


POINTS = {
    "bench-fast": _bench(dataclasses.replace(_BENCH, **_FAST)),
    "bench-exact": _bench(_BENCH),
    "kitti-exact": _kitti(KITTI_PARAMS),
    "kitti-fast": _kitti(dataclasses.replace(KITTI_PARAMS, dedup_triangles=False,
                                             per_anchor_candidates=4)),
}


_KERNEL_NAME = re.compile(r"\(anonymous namespace\)::(\w+)")


def own_kernel_names() -> set:
    """The `__global__` functions of the hand-written kernels (csrc/)."""
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {name for src in _build.sources() for name in decl.findall(src.read_text())}


def _device_us(row) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, name):
            return float(getattr(row, name))
    return 0.0


def _profile(fn, batches: int):
    """The CUDA kernel rows of `torch.profiler` over `batches` calls of fn."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
    return [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA and _device_us(r) > 0]


def kernel_device_ms(fn, reps: int = 10) -> float:
    """Device ms of one launch of each hand-written kernel that `fn`
    launches once, summed: `torch.profiler` over `reps` calls after one
    warm-up call, each kernel's device time over the launches the profiler
    recorded (it may drop some)."""
    fn()
    torch.cuda.synchronize()
    names = own_kernel_names()
    total_us = 0.0
    for r in _profile(fn, reps):
        m = _KERNEL_NAME.search(r.key)
        if m and m.group(1) in names:
            total_us += _device_us(r) / r.count
    return total_us / 1e3


def profile_point(name: str, reps: int, batches: int) -> dict:
    dev = torch.device("cuda", 0)
    (P, Q), params = POINTS[name](dev)
    register_batch(P, Q, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        register_batch(P, Q, params)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = _profile(lambda: register_batch(P, Q, params), batches)
    busy_ms = sum(_device_us(r) for r in kernels) / 1e3 / batches
    top = sorted(kernels, key=_device_us, reverse=True)[:5]
    names, own = own_kernel_names(), {}
    for r in kernels:
        m = _KERNEL_NAME.search(r.key)
        if m and m.group(1) in names:
            own[m.group(1)] = own.get(m.group(1), 0.0) + _device_us(r) / 1e3 / batches
    return dict(
        point=name, batch=P.shape[0], n=P.shape[1], wall_ms_per_batch=wall_ms,
        device_busy_ms_per_batch=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        kernels_per_batch=sum(r.count for r in kernels) / batches,
        top_kernels=[dict(name=r.key[:80], ms_per_batch=_device_us(r) / 1e3 / batches,
                          calls_per_batch=r.count / batches) for r in top],
        own_kernels_ms_per_batch=own,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("points", nargs="+", choices=sorted(POINTS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in args.points:
        print(json.dumps(profile_point(name, args.reps, args.batches)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
