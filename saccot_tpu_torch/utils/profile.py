"""Profile `register_batch` at a named operating point on one GPU.

    python -m saccot_tpu_torch.utils.profile kitti-exact kitti-fast [--reps 5]

For each point it prints one JSON line: the wall ms per batch (host clock
around `--reps` batches ending in `torch.cuda.synchronize()`, after one
warm-up batch), and from `torch.profiler` over `--batches` batches the device
busy ms per batch (the sum of CUDA kernel times; the port runs on one
stream), the idle share 1 - busy / wall, the kernels launched per batch, the
five kernels with the most device time, and the device ms per batch of each
hand-written kernel (`csrc/`), and for each stage of the estimator (its
`saccot/<stage>` range) the host and device ms, the device operations it
launched and the blocking runtime calls inside it (`range_counts`). Needs
a CUDA device. `kernel_device_ms`
gives the same device ms of the hand-written kernels for any call
(`chip_smoke.py` reads it beside the CUDA-event times of the degree kernels),
and `launch_floor_ms` that of an empty kernel launched as one thread: the
least any launch takes on the card, as this reading sees it.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import re
import sys
import time
from typing import Optional

import torch

from saccot_tpu_torch.engine import sac_cot
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch
from saccot_tpu_torch.utils.params import SacCotParams
from saccot_tpu_torch.utils.profiling import is_warm_up, profiler

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


def _capture(fn, batches: int):
    """A `utils.profiling.profiler` capture of `batches` calls of fn (the
    device is traced where there is one)."""
    with profiler() as prof:
        for _ in range(batches):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return prof


def profiler_rows(fn, batches: int):
    """`torch.profiler`'s rows (`key_averages()`) over `batches` calls of fn."""
    return _capture(fn, batches).key_averages()


def _kernel_rows(rows):
    """The CUDA kernel rows, without the device side of `record_function`
    ranges (a range's span, not a kernel) and without the capture's
    warm-up (`utils.profiling.profiler`)."""
    return [r for r in rows if r.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(r, "is_user_annotation", False) and _device_us(r) > 0
            and not is_warm_up(r.key)]


def _profile(fn, batches: int):
    """The CUDA kernel rows of `torch.profiler` over `batches` calls of fn."""
    return _kernel_rows(profiler_rows(fn, batches))


def range_ms(rows, prefix: str, batches: int) -> dict:
    """{name: dict(calls, host_ms)} a call, for each `record_function` range
    named prefix + name among the profiler's rows over `batches` calls: its
    entries and the host wall ms inside it. The device side is
    `range_counts`': a row holds only the kernels that torch operators
    launched, not those of the ctypes launches of `csrc/`."""
    return {r.key[len(prefix):]: dict(calls=r.count / batches,
                                      host_ms=r.cpu_time_total / 1e3 / batches)
            for r in rows
            if r.device_type == torch.autograd.DeviceType.CPU and r.key.startswith(prefix)}


# The CUDA runtime calls that hold the calling thread until the card has
# caught up (a stream, the device, an event, or a copy that is not `Async`).
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy")


def _is_runtime_call(ev) -> bool:
    """A host record of the CUDA runtime or driver API (`cudaLaunchKernel`,
    `cuLaunchKernel`, `cudaMemcpyAsync`, ...), not an operator or a range."""
    return ev.device_type == torch.autograd.DeviceType.CPU and ev.name.startswith("cu")


def range_counts(events, prefix: str, batches: int) -> dict:
    """{name: dict(device_ms, device_ops, syncs, sync_ms)} a call, for
    each `record_function` range named prefix + name among the events of a
    capture (`prof.events()`) over `batches` calls: the device operations
    (kernels, copies, fills) launched inside it and their device ms, and
    the blocking runtime calls (`BLOCKING_CALLS`) inside it, with their host
    ms. A device operation is put down to the runtime call that launched it
    by the two records' correlation id (never by its name or its time on the
    card), and a runtime call to the range whose host interval holds its
    start: the ranges of one call do not overlap, and a call runs on one
    thread. A runtime call that a torch operator made carries that
    operator's thread; one made outside torch (a ctypes launch) carries the
    OS thread's id, so a call on another torch thread is left out, one
    outside torch is placed by time alone. A range's own span on the card
    is not an operation."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = sorted(((e.time_range.start, e.time_range.end, e.thread, e.name[len(prefix):])
                    for e in events if e.device_type == cpu and e.name.startswith(prefix)),
                   key=lambda s: s[0])
    starts = [s[0] for s in spans]
    threads = {e.thread for e in events if e.device_type == cpu and not _is_runtime_call(e)}
    out = {s[3]: dict(device_ms=0.0, device_ops=0, syncs=0, sync_ms=0.0) for s in spans}

    def holder(call):
        i = bisect.bisect_right(starts, call.time_range.start) - 1
        if i < 0:
            return None
        start, end, thread, name = spans[i]
        if call.time_range.start > end or (call.thread in threads and call.thread != thread):
            return None
        return out[name]

    launches = {}
    for ev in events:
        if not _is_runtime_call(ev):
            continue
        launches[ev.id] = ev
        row = holder(ev) if ev.name in BLOCKING_CALLS else None
        if row is not None:
            row["syncs"] += 1
            row["sync_ms"] += (ev.time_range.end - ev.time_range.start) / 1e3
    for ev in events:
        if ev.device_type != cuda or getattr(ev, "is_user_annotation", False):
            continue
        call = launches.get(ev.id)
        row = None if call is None else holder(call)
        if row is not None:
            row["device_ops"] += 1
            row["device_ms"] += (ev.time_range.end - ev.time_range.start) / 1e3
    return {name: {k: v / batches for k, v in row.items()} for name, row in out.items()}


def kernel_device_ms(fn, reps: int = 10, attempts: int = 5) -> float:
    """Device ms of the hand-written kernels of one call of `fn`:
    `torch.profiler` over `reps` calls after one warm-up call, each kernel
    (each instance of a template) its device time over the launches the
    profiler recorded (it may drop some), times the launches a call made
    (recorded over `reps`, rounded, at least one). A reading that recorded
    none of them (it can drop all) is taken again, at most `attempts` times
    in all."""
    fn()
    torch.cuda.synchronize()
    names = own_kernel_names()
    for _ in range(attempts):
        rows = [r for r in _profile(fn, reps)
                if (m := _KERNEL_NAME.search(r.key)) and m.group(1) in names]
        if rows:
            return sum(_device_us(r) / r.count * max(1, round(r.count / reps))
                       for r in rows) / 1e3
    raise RuntimeError(f"the profiler recorded no launch of the port's kernels in {attempts} "
                       "readings")


def launch_floor_ms(reps: int = 10) -> float:
    """`kernel_device_ms` of the empty kernel of `csrc/launch_floor.cu`, one
    thread on the current stream."""
    lib = _build.library()

    def launch():
        _build.check(lib.saccot_empty(torch.cuda.current_stream().cuda_stream), "empty_kernel")

    return kernel_device_ms(launch, reps)


def profile_call(fn, reps: int = 5, batches: int = 3, ranges: Optional[str] = None) -> dict:
    """The wall ms of one call of fn (host clock around `reps` calls after
    one warm-up, ending in `torch.cuda.synchronize()`), and from
    `torch.profiler` over `batches` calls: the device busy ms a call (the
    sum of CUDA kernel times; the port runs on one stream), the idle share
    1 - busy / wall, the kernels launched a call, the five kernels with the
    most device time, the device ms a call of each hand-written kernel and,
    given a prefix `ranges`, `range_ms` and `range_counts` of the ranges it
    names."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    prof = _capture(fn, batches)
    rows = prof.key_averages()
    kernels = _kernel_rows(rows)
    busy_ms = sum(_device_us(r) for r in kernels) / 1e3 / batches
    top = sorted(kernels, key=_device_us, reverse=True)[:5]
    names, own = own_kernel_names(), {}
    for r in kernels:
        m = _KERNEL_NAME.search(r.key)
        if m and m.group(1) in names:
            own[m.group(1)] = own.get(m.group(1), 0.0) + _device_us(r) / 1e3 / batches
    return dict(
        wall_ms_per_batch=wall_ms, device_busy_ms_per_batch=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms,
        kernels_per_batch=sum(r.count for r in kernels) / batches,
        top_kernels=[dict(name=r.key[:80], ms_per_batch=_device_us(r) / 1e3 / batches,
                          calls_per_batch=r.count / batches) for r in top],
        own_kernels_ms_per_batch=own,
        **({} if ranges is None else dict(ranges=_ranges(prof, rows, ranges, batches))),
    )


def _ranges(prof, rows, prefix: str, batches: int) -> dict:
    counts = range_counts(prof.events(), prefix, batches)
    return {name: {**row, **counts[name]}
            for name, row in range_ms(rows, prefix, batches).items()}


def profile_point(name: str, reps: int, batches: int) -> dict:
    dev = torch.device("cuda", 0)
    (P, Q), params = POINTS[name](dev)
    return dict(point=name, batch=P.shape[0], n=P.shape[1],
                **profile_call(lambda: sac_cot.register_batch(P, Q, params), reps, batches,
                               ranges=sac_cot.STAGE_PREFIX))


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
