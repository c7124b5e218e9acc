"""Time the streamed anchor kernel under other launch plans than `stream_plan`'s.

    python -m saccot_tpu_torch.scripts.exp_stream_plan [reps]

At the shapes the port gives the kernel (the kitti point, 2 x 512 anchors x
50,000 columns; N=5,000, just above MAX_N_FUSED; the kitti point's first 256
anchors, an anchor shard; B=16 throughout), it launches
`csrc/anchor_topb_stream.cu` on each plan of W warps a block in {2, 4, 8} x
chunks of {256, ..., 4096} columns, with the per-anchor floors and without
them (every chunk keeps its B rounds), checks that every launch gives the
bits of `stream_plan`'s and that those are within 1e-6 of the plain version,
and prints the kernel's device ms (`utils.profile.kernel_device_ms` over
`reps` calls) and the CUDA-event ms per call around `reps` calls issued back
to back (the wrapper's host work included). A plan whose block needs more
than the 48 KB of shared memory the kernel takes is listed and skipped. Then the
registers ptxas reported for each instance of the kernel, and the
instructions of each instance's loops. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import triangles as ktri
from saccot_tpu_torch.scripts.exp_compat_ops import sass_loops
from saccot_tpu_torch.scripts.exp_degree_plan import back_to_back_ms
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch
from saccot_tpu_torch.utils.profile import kernel_device_ms

# (name, batch, anchors A, columns N): the anchors are the A of highest degree.
SHAPES = [("kitti", 2, 512, 50000), ("N=5000", 2, 512, 5000), ("anchor shard", 2, 256, 50000)]
WARPS = (2, 4, 8)
CHUNK_N = (256, 512, 1024, 2048, 4096)


def plans(batch: int, A: int, N: int):
    """Every (warps, chunk_n) of the sweep as a grid of the shape."""
    for warps in WARPS:
        for chunk_n in CHUNK_N:
            yield ktri.make_stream_plan(batch, A, N, warps, chunk_n)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        print("exp_stream_plan: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi.stdout.strip()}")
    kp = KITTI_PARAMS
    B, tau, sep = kp.neighbors_per_anchor, kp.compat_tau, kp.min_separation
    sms = kcompat.sm_count(dev)
    for name, batch, A, N in SHAPES:
        P, Q, _ = kitti_problem_batch(range(KITTI_SEED, KITTI_SEED + batch), device=dev, n=N)
        anchors = ktri.topk_stable(kcompat.degrees(P, Q, P, Q, kp), 512)[1][:, :A].contiguous()
        args = (P, Q, anchors, B, tau, sep, None, None)
        chosen = ktri.stream_plan(batch, A, N, B, sms)
        want = ktri._stream(*args, chosen)
        ref = ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep)
        err = (want[0] - ref[0]).abs().max().item()
        print(f"{name} ({batch} x {A} anchors x {N} columns, B={B}): stream_plan warps="
              f"{chosen.warps} chunk_n={chosen.chunk_n}, {chosen.blocks} blocks; "
              f"max |kernel - plain| {err:.3g}", flush=True)
        if err > 1e-6:
            return 1
        for plan in plans(batch, A, N):
            tag = (f"  warps={plan.warps} chunk_n={plan.chunk_n:4d} chunks={plan.chunks:3d} "
                   f"blocks={plan.blocks:6d} smem={plan.smem_bytes:6d}")
            if plan.smem_bytes > ktri.ANCHOR_SMEM_BUDGET:
                print(f"{tag}: more than 48 KB of shared memory", flush=True)
                continue
            out = []
            for floors in (True, False):
                got = ktri._stream(*args, plan, floors=floors)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    print(f"{tag} floors={floors}: BITS DIFFER", flush=True)
                    return 1

                def call():
                    return ktri._stream(*args, plan, floors=floors)

                out.append(f"device {kernel_device_ms(call, reps):.4f} ms, "
                           f"events {back_to_back_ms(call, reps):.4f} ms")
            print(f"{tag}: {out[0]}; without floors {out[1]}", flush=True)
    source = None
    for line in _build.build_log.splitlines():
        source = line[3:] if line.startswith("== ") else source
        if source == "anchor_topb_stream.cu" and ("registers" in line or "entry" in line):
            print("  ptxas:", line.split("ptxas info    :")[-1].strip()[:160])
    for fn, loops in sass_loops("anchor_topb_stream_kernel").items():
        name = fn[fn.index("anchor_topb_stream_kernel"):][:48]
        print(f"  sass {name}: loop bodies {loops[:6]} instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
