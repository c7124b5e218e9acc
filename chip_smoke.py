#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the SAC-COT estimator once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. require a CUDA device; print the card's name and power limit; turn TF32
     off for matmuls and cuDNN;
  2. build the kernels from saccot_tpu_torch/csrc (one nvcc -c per source,
     started together, then one link);
  3. each kernel against its plain PyTorch version on the card, at the bench
     shapes (batch 128, N=1000, A=256, B=12, K=1024), with the stated
     tolerances, and the median time of each over CUDA-event-timed reps
     (the degree kernels also their device time from the profiler); the
     fused anchor kernel's selections bit for bit against the streamed
     kernel's (column tiles of 256) and its top-T mode against
     `candidate_topt` on its own selections (`hold_anchor`); score's counts
     identical to the plain version's, its weighted mode within the stated
     tolerance, bit-identical across two calls and for half the hypotheses
     scored alone (`hold_score`); the warps per block of the anchor kernel
     and the point splits of the score kernel at each shape, and the
     two-sided degree loop's `degree_plan` (rows a thread, column splits)
     at every degree shape of phases 3, 6, 8 and 10;
  4. `register_batch` at the bench point (128 planted pairs, seeds 1000+s,
     80% outliers, noise 0.004) in the fast and the exact configuration:
     recall under the 5 deg / 0.05 criterion, launch counts of every kernel
     during that run, and pairs/s;
  5. the 3DMatch sweep point (32 pairs, seeds 300+s, N=2048, 90% outliers,
     noise 0.01, exact configuration, 15 deg / 0.30 criterion) through the
     kernels and through the plain versions on the card; the fused anchor
     and score kernels at its shapes (256 anchors, B=16, N=2048; 2,048
     hypotheses a pair), held as in phase 3;
  6. the large-N kernels against their plain versions at the kitti shapes
     (batch 2, N=50,000, A=512, B=16, T=4, K=2048): the symmetric degree
     kernel (also bit-identical across two calls, and against the two-sided
     kernel), the streamed top-B (also bit-identical to the fused kernel at
     N=3,000 over three column tiles), the candidate top-T (also against the
     fused kernel's top-T mode), and the solve and score kernels at N=50,000,
     score held as in phase 3 there and at the SP shard's 25,000 points;
  7. `register_batch` at the kitti configuration (seeds 500-501, 70%
     outliers, 5 deg / 0.6 m criterion), exact and fast variant, through the
     kernels and through the plain versions: recall, inliers per pair, ms per
     pair and the launch counts of every kernel during the kernel runs;
  8. the ring-step kernel and the direct-form degree route: ring sums over
     d = 2 and 4 blocks at the kitti shapes against the plain step, against
     the symmetric kernel's degrees and bit for bit across two calls; at the
     bench shapes (d = 2) against `degrees(mxu=False)`; the direct route
     against the plain degrees at the bench shapes and at the 3DMatch point's
     sharded shape; the one loop's bit identities: the SP row slice and a
     batch slice of the 3DMatch point against the full call, which other
     grids (rows a thread, split counts) repeat too, and a ring step at
     d = 1 on a zeroed deg against the direct route at the bench, 3DMatch
     and kitti points; CUDA-event times of one step;
  9. the distributed estimator on two spawned ranks (`dist/local.run_ranks`;
     NCCL with a card per rank when there are two cards, else gloo on the one
     card): DP over pairs and TP over hypotheses at the bench point, SP with
     the ring at the kitti configuration, SP without it at the 3DMatch point,
     each held to the single-rank runs of phases 4, 5 and 7; which
     collectives gloo takes on CUDA tensors; each rank's launch counts;
 10. the degree loop's per-operation attribution (`compat_ops.cu`, the TPU
     script scripts/exp_compat_ops.py): each of its five modes in both forms
     against its plain version at N=3,000 and, on the script's pair, at
     N=50,000, `full` there bit for bit against the production tri and
     two-sided kernels, then that script's path
     (`saccot_tpu_torch.scripts.exp_compat_ops`) at N=50,000 with its launch
     counts, and one {"compat_ops": {...}} line of the ten times.
Each kernel row carries its bound: the larger of its FP32 operations over
the card's FP32 instruction rate and its bytes over the memory rate
(`bound_ms`, from the attribution script). The line before the last is a
JSON table of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time


# The card's yardstick (FP32 instruction and memory rates), the instructions
# of one scored pair (PAIR_OPS: distances, two roots, the predicate, the
# i != j test and the masked accumulate) and the CUDA-event timer are defined
# once, beside the per-operation attribution that measures them.
from saccot_tpu_torch.scripts.exp_compat_ops import PAIR_OPS, bound_ms, sass_loops, time_ms

# One 3-point solve: gathers, centroids and the 9-entry covariance (~90),
# Horn's matrix and eight renormalised 4x4 squarings (~1,050), the column
# pick, two polish steps and the rotation (~210).
SOLVE_OPS = 1350
# One (hypothesis, point) score: the residual (3 x 7), its square (5), the
# threshold and the count.
SCORE_OPS = 28


class PhaseError(RuntimeError):
    pass


def degrees_cost(b, R, C, same=False, masked=False):
    """(ops, bytes) of weighted degrees of R rows against C columns: P and Q
    read once (rows and columns once each unless they are the same tensors),
    the masks, the degrees written."""
    pts = R if same else R + C
    return PAIR_OPS * b * R * C, 4 * b * (6 * pts + (pts if masked else 0) + R)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def off_ties(s, gap):
    """[..., B] mask of selections whose score differs from both rank
    neighbours' by at least `gap` (ties may legally swap indices)."""
    import torch

    tie = torch.zeros_like(s, dtype=torch.bool)
    close = (s[..., :-1] - s[..., 1:]).abs() < gap
    tie[..., :-1] |= close
    tie[..., 1:] |= close
    return ~tie


def plan_str(plan):
    """One kernel plan as `field=value` pairs."""
    return ", ".join(f"{k}={v}" for k, v in dataclasses.asdict(plan).items())


def degree_plan_str(batch, R, C):
    """`degree_plan` of batch x R rows against C columns on card 0."""
    import torch

    from saccot_tpu_torch.kernels import compat as kcompat

    plan = kcompat.degree_plan(batch, R, C, kcompat.sm_count(torch.device("cuda", 0)))
    return f"{plan_str(plan)}, {plan.blocks} blocks"


def hold_anchor(P, Q, anchors, B, T, tau, sep, where):
    """The fused anchor kernel in both modes against its plain version, its
    selections bit for bit against the streamed kernel's (unchanged, column
    tiles of 256) and its top-T against `candidate_topt` on its own
    selections. Returns the worst error of each mode."""
    import torch

    from saccot_tpu_torch.kernels import triangles as ktri

    stream = ktri.anchor_neighbors_stream(P, Q, anchors, B, tau, sep, tile_n=256)
    errs = {}
    for mode, kw in (("candidates", {"emit_candidates": True}), ("topt", {"top_t": T})):
        got = ktri.anchor_neighbors(P, Q, anchors, B, tau, sep, **kw)
        ref = ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep, **kw)
        # Top-B scores exact to 1e-6: both sides evaluate the one predicate
        # with the same unfused operations. Indices must agree wherever the
        # neighbouring scores are not within 1e-6 (ties may swap).
        err_s = (got[0] - ref[0]).abs().max().item()
        check(err_s <= 1e-6, f"anchor_topb {mode} at {where}: top-B scores differ by {err_s}")
        clear = off_ties(ref[0], 1e-6)
        check(torch.equal(got[1][clear], ref[1][clear]),
              f"anchor_topb {mode} at {where}: indices differ")
        # Candidates atol 1e-5 (sums of three scores of equal operations).
        err_c = (got[2] - ref[2]).abs().max().item()
        check(err_c <= 1e-5, f"anchor_topb {mode} at {where}: candidates differ by {err_c}")
        if mode == "topt":
            clear_t = off_ties(ref[2], 1e-6) & (ref[2] > 0)
            check(torch.equal(got[3][clear_t], ref[3][clear_t])
                  and torch.equal(got[4][clear_t], ref[4][clear_t]),
                  f"anchor_topb topt at {where}: decoded node ids differ")
            ct = ktri.candidate_topt(got[0], got[1], *ktri.gather_neighbors(P, Q, got[1]), T,
                                     tau, sep)
            check(all(torch.equal(x, y) for x, y in zip(ct, got[2:])),
                  f"anchor_topb topt at {where} differs from candidate_topt on its selections")
        # The warp-scope selection against the block-scope one: bit for bit,
        # since the key is a total order.
        check(torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1]),
              f"anchor_topb {mode} at {where}: selections differ from anchor_neighbors_stream")
        errs[mode] = max(err_s, err_c)
    A, N = anchors.shape[1], P.shape[1]
    plan = ktri.anchor_plan(N, B)
    print(f"  anchor_topb at {where} (batch {P.shape[0]}, N={N}, A={A}, B={B}): {plan_str(plan)}, "
          f"{-(-A // plan.warps)} blocks a pair; scores within 1e-6 of plain; selections "
          "bit-identical to anchor_neighbors_stream(tile_n=256), top-T to candidate_topt",
          flush=True)
    return errs


def hold_score(r9, t3, P, Q, tau, where):
    """The score kernel against its plain version. Counts identical for every
    hypothesis (each operation of the residual rounded on its own, as the
    plain version does: no FMA), count-mode scores equal to them. Weighted
    scores within `weighted_rtol(N)` of the plain version (the same terms,
    bit for bit, summed in another order), the same bits in two calls and
    for the second half of the hypotheses scored alone, a tensor-parallel
    rank's share (the kernel's order of the sums depends on N alone)."""
    import torch

    from saccot_tpu_torch.kernels import score as kscore

    batch, _, K = r9.shape
    N = P.shape[1]
    s, c = kscore.score_hypotheses(r9, t3, P, Q, tau)
    rc = kscore.score_hypotheses_reference(r9, t3, P, Q, tau)[1]
    diff = (c - rc).abs()
    check(diff.max().item() == 0, f"score at {where}: counts identical for "
          f"{(diff == 0).float().mean().item():.5f}, max diff {diff.max().item()}")
    check(torch.equal(s, c.float()), f"score at {where}: count-mode scores are not the counts")
    ws, wc = kscore.score_hypotheses(r9, t3, P, Q, tau, mode="weighted")
    wr = kscore.score_hypotheses_reference(r9, t3, P, Q, tau, mode="weighted")[0]
    check(torch.equal(wc, rc), f"score weighted at {where}: counts differ")
    rtol = kscore.weighted_rtol(N)
    torch.testing.assert_close(ws, wr, rtol=rtol, atol=0.0)
    check(torch.equal(ws, kscore.score_hypotheses(r9, t3, P, Q, tau, mode="weighted")[0]),
          f"score weighted at {where}: two calls differ")
    h = K // 2
    half = kscore.score_hypotheses(r9[:, :, h:].contiguous(), t3[:, :, h:].contiguous(), P, Q,
                                   tau, mode="weighted")[0]
    check(torch.equal(half, ws[:, h:]),
          f"score weighted at {where}: hypotheses {h}.. scored alone differ")
    sms = torch.cuda.get_device_properties(P.device).multi_processor_count
    print(f"  score at {where} (batch {batch}, K={K}, N={N}): "
          f"{plan_str(kscore.score_plan(batch, K, N, sms))}; counts identical; weighted "
          f"max |kernel - plain| {(ws - wr).abs().max().item():.4g} (rtol {rtol:.3g}), "
          f"bit-identical across two calls and for hypotheses {h}.. alone "
          f"({plan_str(kscore.score_plan(batch, K - h, N, sms))})", flush=True)


def rot_deg(T_a, T_b):
    """Rotation angle in degrees between two 4x4 transforms."""
    import numpy as np

    E = np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64))
    return float(np.degrees(np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))))


def recall_np(T, T_gt, rot_thresh_deg, trans_thresh):
    from saccot_tpu_torch.evaluation.metrics import registration_recall

    return registration_recall(zip(T, T_gt), rot_thresh_deg, trans_thresh)


def gloo_cuda_probe(dev):
    """Which collectives a gloo group runs on CUDA tensors itself (True) or
    refuses (the error's first line)."""
    import torch
    import torch.distributed as dist

    out = {}
    x = torch.ones(4, device=dev)
    for name, call in (
        ("all_reduce", lambda: dist.all_reduce(x.clone())),
        ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x)),
        ("all_gather_into_tensor",
         lambda: dist.all_gather_into_tensor(torch.empty(8, device=dev), x)),
    ):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = True
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:120]
    return out


def phase9_rank(fast, exact, kitti, tdm):
    """One rank of phase 9 (spawned by `run_ranks`, which has already joined
    the process group): DP, TP and SP runs; results and launch counts."""
    import time

    import torch
    import torch.distributed as dist

    from saccot_tpu_torch.dist.mesh import axis_group, make_mesh
    from saccot_tpu_torch.dist.sweep import make_sweep_fn
    from saccot_tpu_torch.engine.sac_cot import register_batch_sp, register_batch_tp
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.utils.convert import KITTI_SEED, kitti_problem_batch, problem_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    out = dict(rank=dist.get_rank(), backend=backend, device=dev.index,
               card=torch.cuda.get_device_name(dev))
    if backend == "gloo":
        out["gloo_cuda"] = gloo_cuda_probe(dev)
    P, Q, _ = problem_batch(range(1000, 1128), device=dev, n=1000, outlier_ratio=0.8, noise=0.004)
    dp = make_mesh(pairs=2)
    for name, params in (("fast", fast), ("exact", exact)):
        out[f"dp_{name}"] = make_sweep_fn(dp, params)(P, Q)
    tp = make_mesh(pairs=1, hyp=2)
    out["tp"] = register_batch_tp(P, Q, fast, axis_group(tp, "hyp"))
    sp = make_mesh(pairs=1, corr=2)
    g, r = axis_group(sp, "corr"), sp.get_local_rank("corr")

    def shard(x):
        n = x.shape[1] // 2
        return x[:, r * n:(r + 1) * n].contiguous()

    ring = dataclasses.replace(kitti, ring_compat=True)
    PK, QK, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev)
    PK, QK = shard(PK), shard(QK)
    torch.cuda.synchronize()
    _build.reset_launches()
    out["sp_ring"] = register_batch_sp(PK, QK, ring, g)
    torch.cuda.synchronize()
    out["sp_ring_launches"] = _build.launches()
    reps = 3
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        register_batch_sp(PK, QK, ring, g)
    torch.cuda.synchronize()
    out["sp_ring_ms_per_pair"] = (time.perf_counter() - t0) * 1e3 / (reps * 2)
    P3, Q3, _ = problem_batch(range(300, 332), device=dev, n=2048, outlier_ratio=0.9, noise=0.01)
    P3, Q3 = shard(P3), shard(Q3)
    torch.cuda.synchronize()
    _build.reset_launches()
    out["sp_3dm"] = register_batch_sp(P3, Q3, tdm, g)
    torch.cuda.synchronize()
    out["sp_3dm_launches"] = _build.launches()
    return out


def main():
    import numpy as np
    import torch

    # -- phase 1: the card ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is still enabled")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 ok: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from saccot_tpu_torch import SacCotParams, register_batch
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import score as kscore
    from saccot_tpu_torch.kernels import solve3 as ksolve
    from saccot_tpu_torch.kernels import triangles as ktri
    from saccot_tpu_torch.utils.convert import (
        KITTI_CRITERION, KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch, recall,
    )
    from saccot_tpu_torch.utils.profile import kernel_device_ms

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 ok: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    # The loops of the two kernels redesigned for Hopper, as compiled, longest
    # first: score's point-tile loop, then its inner loop over 4 points x 2
    # hypotheses; the anchor kernel's row loop over 2 columns with and
    # without a column mask, then its selection rounds.
    for name in ("score_kernel", "anchor_topb_kernel"):
        for fn, loops in sass_loops(name).items():
            print(f"  sass {fn[fn.index(name):][:40]}: loop bodies {loops[:4]} instructions")
    # The one two-sided degree loop in its production instances (the direct
    # routes and the ring step, each at 2 and 1 rows a thread): a column
    # segment (staging, both sweeps, the segment sum), then the sweep with
    # and without the i != j test, 2 columns x the rows a pass.
    for fn, loops in sass_loops("two_sided_degrees_kernel").items():
        if "CompatScore" in fn:
            src = "ring_degrees" if "ring_degrees_cu" in fn else "compat_degrees"
            rows = re.search(r"two_sided_degrees_kernelILi(\d)E", fn).group(1)
            print(f"  sass two_sided_degrees_kernel ({src}.cu, {rows} rows a thread): "
                  f"loop bodies {loops[:4]} instructions")

    # -- phase 3: kernels vs plain versions at the bench shapes ------------
    fast = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=256,
        neighbors_per_anchor=12, max_hypotheses=1024, dedup_triangles=False,
        approx_topk=True, per_anchor_candidates=4,
    )
    exact = dataclasses.replace(fast, dedup_triangles=True, approx_topk=False,
                                per_anchor_candidates=0)
    P, Q, T_gt = problem_batch(range(1000, 1128), device=dev, n=1000, outlier_ratio=0.8,
                               noise=0.004)
    A, B, T = 256, 12, 4
    tau, sep = fast.compat_tau, fast.min_separation
    rows = []

    def solve_cost(b, n, k):
        # triples read, the point rows they name (at most 3K), r9 and t3 written
        return SOLVE_OPS * b * k, 24 * b * k + 24 * b * min(n, 3 * k) + 48 * b * k

    def score_cost(b, n, k):
        return SCORE_OPS * b * k * n, 24 * b * n + 48 * b * k + 8 * b * k

    def row(name, source, replaces, err, ms, plain_ms, counter, cost, **extra):
        b_ms, b_by = bound_ms(*cost)
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         counter=counter, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra))
        more = "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k}: {v}"
                       for k, v in extra.items())
        print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}){more}", flush=True)

    # Degrees: rtol 1e-5, atol 1e-3 — the kernel sums each row in column
    # order, the plain version in torch's reduction order.
    deg = kcompat.degrees(P, Q, P, Q, fast)
    deg_ref = kcompat.degrees_reference(P, Q, P, Q, fast)
    torch.testing.assert_close(deg, deg_ref, rtol=1e-5, atol=1e-3)
    row("compat_degrees", "saccot_tpu_torch/csrc/compat_degrees.cu",
        "saccot_tpu/kernels/compat.py:96", (deg - deg_ref).abs().max().item(),
        time_ms(lambda: kcompat.degrees(P, Q, P, Q, fast)),
        time_ms(lambda: kcompat.degrees_reference(P, Q, P, Q, fast)), "compat_degrees",
        degrees_cost(128, 1000, 1000, same=True),
        device_ms=kernel_device_ms(lambda: kcompat.degrees(P, Q, P, Q, fast)),
        plan=degree_plan_str(128, 1000, 1000))

    _, anchors = ktri.topk_stable(deg_ref, A)
    cands = 128 * A * B * (B - 1) // 2
    anchor_in = 4 * 128 * 1000 * 6 + 8 * 128 * A + 12 * 128 * A * B
    anchor_cost = {
        "candidates": ((PAIR_OPS + 1) * 128 * A * 1000 + (PAIR_OPS + 3) * cands,
                       anchor_in + 4 * cands),
        "topt": ((PAIR_OPS + 1) * 128 * A * 1000 + (PAIR_OPS + 4) * cands,
                 anchor_in + 20 * 128 * A * T),
    }
    anchor_err = hold_anchor(P, Q, anchors, B, T, tau, sep, "the bench point")
    for mode, kw in (("candidates", {"emit_candidates": True}), ("topt", {"top_t": T})):
        row(f"anchor_topb_{mode}", "saccot_tpu_torch/csrc/anchor_topb.cu",
            "saccot_tpu/kernels/triangles.py:42", anchor_err[mode],
            time_ms(lambda: ktri.anchor_neighbors(P, Q, anchors, B, tau, sep, **kw)),
            time_ms(lambda: ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep, **kw)),
            f"anchor_topb_{mode}", anchor_cost[mode])

    pool = tri_mod.triangle_pool_from_points(P, Q, deg_ref, exact, impl="plain")
    triples = pool.triples
    r9, t3 = ksolve.solve3(P, Q, triples)
    r9_ref, t3_ref = ksolve.solve3_reference(P, Q, triples)
    # Solve atol 1e-4: nvcc may contract to FMA where the plain version does
    # not (the kernel spells every operation as an explicitly rounded one).
    err = max((r9 - r9_ref).abs().max().item(), (t3 - t3_ref).abs().max().item())
    check(err <= 1e-4, f"solve3: r9/t3 differ by {err}")
    row("solve3", "saccot_tpu_torch/csrc/solve3.cu", "saccot_tpu/kernels/solve3.py:73", err,
        time_ms(lambda: ksolve.solve3(P, Q, triples)),
        time_ms(lambda: ksolve.solve3_reference(P, Q, triples)), "solve3",
        solve_cost(128, 1000, triples.shape[1]))

    hold_score(r9_ref, t3_ref, P, Q, fast.inlier_tau, "the bench point")
    row("score", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31", 0.0,
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, P, Q, fast.inlier_tau)),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, P, Q,
                                                          fast.inlier_tau)), "score",
        score_cost(128, 1000, r9_ref.shape[2]))
    print("phase 3 ok", flush=True)

    # -- phase 4: the main path at the bench point ---------------------------
    _build.reset_launches()
    results = {name: register_batch(P, Q, params) for name, params in
               (("fast", fast), ("exact", exact))}
    torch.cuda.synchronize()
    launches = _build.launches()
    for name, res in results.items():
        check(bool(torch.isfinite(res.T).all()) and res.T.shape == (128, 4, 4),
              f"{name}: non-finite or misshapen transforms")
        rec = recall(res, T_gt, 5.0, 0.05)
        check(rec >= 0.98, f"{name}: recall {rec} < 0.98")
        params = fast if name == "fast" else exact
        for _ in range(2):
            register_batch(P, Q, params)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            register_batch(P, Q, params)
        torch.cuda.synchronize()
        rate = 128 * reps / (time.perf_counter() - t0)
        print(f"  {name}: recall {rec:.4f}, {rate:.1f} pairs/s, "
              f"median inliers {res.num_inliers.median().item()}", flush=True)
    for r in rows:
        r["launches"] = launches[r.pop("counter")]
        check(r["launches"] > 0, f"{r['name']} was not launched by register_batch")
    print(f"phase 4 ok: launches {launches}", flush=True)

    # -- phase 5: the 3DMatch sweep point, kernels vs plain versions ---------
    tdm = SacCotParams(compat_tau=0.05, min_separation=0.1, inlier_tau=0.05,
                       num_anchors=256, neighbors_per_anchor=16, max_hypotheses=2048)
    P3, Q3, T3 = problem_batch(range(300, 332), device=dev, n=2048, outlier_ratio=0.9,
                               noise=0.01)
    rec_k = recall(register_batch(P3, Q3, tdm), T3, 15.0, 0.30)
    rec_p = recall(register_batch(P3, Q3, tdm, impl="plain"), T3, 15.0, 0.30)
    check(abs(rec_k - rec_p) <= 1 / 32, f"3DMatch recall: kernels {rec_k}, plain {rec_p}")
    # The two redesigned kernels at the shapes this point gives them: 256
    # anchors in blocks of anchor_plan(2048, 16) warps (a ragged last block),
    # and 2,048 hypotheses a pair against 2,048 points in several splits.
    deg3 = kcompat.degrees_reference(P3, Q3, P3, Q3, tdm)
    _, anc3 = ktri.topk_stable(deg3, tdm.num_anchors)
    hold_anchor(P3, Q3, anc3, tdm.neighbors_per_anchor, 4, tdm.compat_tau, tdm.min_separation,
                "the 3DMatch point")
    pool3 = tri_mod.triangle_pool_from_points(P3, Q3, deg3, tdm, impl="plain")
    hold_score(*ksolve.solve3_reference(P3, Q3, pool3.triples), P3, Q3, tdm.inlier_tau,
               "the 3DMatch point")
    print(f"phase 5 ok: 3DMatch recall kernels {rec_k:.4f}, plain {rec_p:.4f}", flush=True)

    # -- phase 6: the large-N kernels vs plain versions at the kitti shapes --
    kp = KITTI_PARAMS
    kfast = dataclasses.replace(kp, dedup_triangles=False, per_anchor_candidates=4)
    PK, QK, TK = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev)
    A, B, T = kp.num_anchors, kp.neighbors_per_anchor, kfast.per_anchor_candidates
    tau, sep = kp.compat_tau, kp.min_separation
    big = dict(reps=5, warmup=1)     # plain versions take up to a second a call

    # Symmetric degrees: rtol 1e-5, atol 2e-3 (tests/test_kernels.py holds the
    # TPU's tri kernel to its two-sided one so): summation orders differ over
    # 50,000 terms. Two calls must agree bit for bit (no atomics).
    _build.reset_launches()
    deg = kcompat.degrees(PK, QK, PK, QK, kp)
    check(_build.launches()["compat_degrees_tri"] == 1, "degrees did not take the tri route")
    deg_ref = kcompat.degrees_reference(PK, QK, PK, QK, kp)
    torch.testing.assert_close(deg, deg_ref, rtol=1e-5, atol=2e-3)
    check(torch.equal(deg, kcompat.degrees(PK, QK, PK, QK, kp)),
          "compat_degrees_tri: two calls differ")
    deg_2s = kcompat.degrees_two_sided(PK, QK, PK, QK, kp)
    torch.testing.assert_close(deg, deg_2s, rtol=1e-5, atol=2e-3)
    two_sided_ms = time_ms(lambda: kcompat.degrees_two_sided(PK, QK, PK, QK, kp), reps=10)
    row("compat_degrees_tri", "saccot_tpu_torch/csrc/compat_degrees_tri.cu",
        "saccot_tpu/kernels/compat.py:180", (deg - deg_ref).abs().max().item(),
        time_ms(lambda: kcompat.degrees(PK, QK, PK, QK, kp), reps=10),
        time_ms(lambda: kcompat.degrees_reference(PK, QK, PK, QK, kp), **big),
        "compat_degrees_tri",
        ((PAIR_OPS + 1) * 2 * 50000 * 49999 // 2, 4 * 2 * 50000 * 7))
    print(f"  compat_degrees two-sided kernel at the same shape: {two_sided_ms:.4f} ms, "
          f"max |tri - two-sided| {(deg - deg_2s).abs().max().item():.3g} "
          f"({degree_plan_str(2, 50000, 50000)})", flush=True)

    # Streamed top-B: scores within 1e-6 of the plain version (the same
    # predicate, the same operations) and indices equal off ties; ties at the
    # last slot are judged against a top-(B+1).
    _, anchors = ktri.topk_stable(deg_ref, A)
    sargs = (PK, QK, anchors, B, tau, sep)
    got = ktri.anchor_neighbors_stream(*sargs)
    ref = ktri.anchor_neighbors_reference(*sargs)
    err_s = (got[0] - ref[0]).abs().max().item()
    check(err_s <= 1e-6, f"anchor_topb_stream: scores differ by {err_s}")
    wider = ktri.anchor_neighbors_reference(PK, QK, anchors, B + 1, tau, sep)[0]
    clear = off_ties(wider, 1e-6)[..., :B]
    check(torch.equal(got[1][clear], ref[1][clear]), "anchor_topb_stream: indices differ")
    # At N=3,000 with 1,024-column tiles (three tiles) the streamed kernel is
    # the fused one bit for bit.
    P3k, Q3k, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev, n=3000)
    deg3 = kcompat.degrees(P3k, Q3k, P3k, Q3k, kp)
    _, anc3 = ktri.topk_stable(deg3, A)
    a3 = (P3k, Q3k, anc3, B, tau, sep)
    st3 = ktri.anchor_neighbors_stream(*a3, tile_n=1024)
    fu3 = ktri.anchor_neighbors(*a3, top_t=T)
    check(torch.equal(st3[0], fu3[0]) and torch.equal(st3[1], fu3[1]),
          "anchor_topb_stream differs from the fused kernel at N=3000")
    row("anchor_topb_stream", "saccot_tpu_torch/csrc/anchor_topb_stream.cu",
        "saccot_tpu/kernels/triangles.py:201", err_s,
        time_ms(lambda: ktri.anchor_neighbors_stream(*sargs), reps=10),
        time_ms(lambda: ktri.anchor_neighbors_reference(*sargs), **big), "anchor_topb_stream",
        ((PAIR_OPS + 1) * 2 * A * 50000, 4 * 2 * 50000 * 6 + 8 * 2 * A + 12 * 2 * A * B))

    # Candidate top-T: scores within 1e-5 of the plain version (sums of three
    # scores), node ids equal off ties; bit-identical to the fused kernel's
    # top-T mode on the fused kernel's own selections.
    nbr_p, nbr_q = ktri.gather_neighbors(PK, QK, got[1])
    cargs = (got[0], got[1], nbr_p, nbr_q, T, tau, sep)
    cg = ktri.candidate_topt(*cargs)
    cr = ktri.candidate_topt_reference(*cargs)
    err_c = (cg[0] - cr[0]).abs().max().item()
    check(err_c <= 1e-5, f"candidate_topt: scores differ by {err_c}")
    clear_t = off_ties(cr[0], 1e-6) & (cr[0] > 0)
    check(bool(clear_t.any()) and torch.equal(cg[1][clear_t], cr[1][clear_t])
          and torch.equal(cg[2][clear_t], cr[2][clear_t]), "candidate_topt: node ids differ")
    c3 = ktri.candidate_topt(fu3[0], fu3[1], *ktri.gather_neighbors(P3k, Q3k, fu3[1]), T, tau,
                             sep)
    check(all(torch.equal(x, y) for x, y in zip(c3, fu3[2:])),
          "candidate_topt differs from the fused kernel's top-T mode")
    row("candidate_topt", "saccot_tpu_torch/csrc/candidate_topt.cu",
        "saccot_tpu/kernels/triangles.py:378", err_c,
        time_ms(lambda: ktri.candidate_topt(*cargs)),
        time_ms(lambda: ktri.candidate_topt_reference(*cargs)), "candidate_topt",
        ((PAIR_OPS + 4) * 2 * A * B * (B - 1) // 2, 2 * A * B * 36 + 20 * 2 * A * T))

    # Solve and score at N=50,000 (the TPU streamed the solve above its VMEM
    # cap; the direct-index kernels take any N), tolerances as in phase 3.
    kpool = tri_mod.triangle_pool_from_points(PK, QK, deg_ref, kp, impl="plain")
    ktrip = kpool.triples
    r9, t3 = ksolve.solve3(PK, QK, ktrip)
    r9_ref, t3_ref = ksolve.solve3_reference(PK, QK, ktrip)
    err = max((r9 - r9_ref).abs().max().item(), (t3 - t3_ref).abs().max().item())
    check(err <= 1e-4, f"solve3 at N=50000: r9/t3 differ by {err}")
    row("solve3_large_n", "saccot_tpu_torch/csrc/solve3.cu",
        "saccot_tpu/kernels/solve3.py:124", err,
        time_ms(lambda: ksolve.solve3(PK, QK, ktrip)),
        time_ms(lambda: ksolve.solve3_reference(PK, QK, ktrip)), "solve3",
        solve_cost(2, 50000, ktrip.shape[1]))
    kargs = (r9_ref, t3_ref, PK, QK, kp.inlier_tau)
    hold_score(*kargs, "kitti")
    row("score_large_n", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31", 0.0,
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, PK, QK, kp.inlier_tau),
                reps=10),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, PK, QK,
                                                          kp.inlier_tau), **big), "score",
        score_cost(2, 50000, r9_ref.shape[2]))
    weighted_ms = time_ms(lambda: kscore.score_hypotheses(*kargs, mode="weighted"), reps=10)
    print(f"  score weighted at kitti: {weighted_ms:.4f} ms", flush=True)
    # The SP shard's points (the first 25,000 of each pair).
    hold_score(r9_ref, t3_ref, PK[:, :25000].contiguous(), QK[:, :25000].contiguous(),
               kp.inlier_tau, "the SP shard")
    print("phase 6 ok", flush=True)

    # -- phase 7: register_batch at the kitti configuration --------------------
    rot_deg_k, trans_m = KITTI_CRITERION
    planted = 50000 - round(50000 * 0.7)
    kit_launches = {k: 0 for k in _build.LAUNCHES}
    kitti_results = {}
    for name, params in (("exact", kp), ("fast", kfast)):
        _build.reset_launches()
        res = kitti_results[name] = register_batch(PK, QK, params)
        torch.cuda.synchronize()
        launched = _build.launches()
        for k, v in launched.items():
            kit_launches[k] += v
        check(bool(torch.isfinite(res.T).all()) and res.T.shape == (2, 4, 4),
              f"kitti {name}: non-finite or misshapen transforms")
        rec = recall(res, TK, rot_deg_k, trans_m)
        inl = res.num_inliers.tolist()
        check(rec == 1.0, f"kitti {name}: recall {rec} < 1.0")
        check(all(abs(n - planted) <= 0.01 * planted for n in inl),
              f"kitti {name}: inliers {inl} not within 1% of {planted}")
        res_p = register_batch(PK, QK, params, impl="plain")
        rec_p = recall(res_p, TK, rot_deg_k, trans_m)
        check(rec_p == rec, f"kitti {name}: plain recall {rec_p}, kernels {rec}")
        ms = {}
        for impl, reps in (("kernel", 3), ("plain", 1)):
            register_batch(PK, QK, params, impl=impl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                register_batch(PK, QK, params, impl=impl)
            torch.cuda.synchronize()
            ms[impl] = (time.perf_counter() - t0) * 1e3 / (reps * 2)
        print(f"  kitti {name}: recall {rec:.4f} (plain {rec_p:.4f}), inliers {inl} "
              f"(plain {res_p.num_inliers.tolist()}, planted {planted}), "
              f"{ms['kernel']:.3f} ms/pair (plain {ms['plain']:.3f}), "
              f"launches {launched}", flush=True)
    for r in rows:
        if "counter" in r:
            r["launches"] = kit_launches[r.pop("counter")]
            check(r["launches"] > 0, f"{r['name']} was not launched by register_batch at kitti")
    print("phase 7 ok", flush=True)

    # -- phase 8: the ring step and the direct-form degree route ---------------
    from saccot_tpu_torch.kernels import ring_compat as kring

    def ring_sums(Pb, Qb, params, d, step):
        """Degrees of every row block summed over all d column blocks, each
        row block visiting the columns in its ring order."""
        n = Pb.shape[1] // d
        blocks = [kring.pack_block(Pb[:, r * n:(r + 1) * n], Qb[:, r * n:(r + 1) * n])
                  for r in range(d)]
        out = []
        for r in range(d):
            acc = torch.zeros((Pb.shape[0], n), dtype=torch.float32, device=dev)
            for s in range(d):
                src = (r - s) % d
                step(blocks[r], blocks[src], acc, r * n, src * n, params)
            out.append(acc)
        return torch.cat(out, dim=1), blocks

    # Kitti shapes: rtol 1e-5 / atol 2e-3 as phase 6 (50,000-term sums in
    # another order); the kernel sums in a fixed order, so two runs agree bit
    # for bit.
    deg_tri = kcompat.degrees_tri(PK, QK, kp)
    ring_err = 0.0
    for d in (2, 4):
        got, _ = ring_sums(PK, QK, kp, d, kring.ring_degrees_step)
        ref, _ = ring_sums(PK, QK, kp, d, kring.ring_degrees_step_reference)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-3)
        torch.testing.assert_close(got, deg_tri, rtol=1e-5, atol=2e-3)
        check(torch.equal(got, ring_sums(PK, QK, kp, d, kring.ring_degrees_step)[0]),
              f"ring_degrees at d={d}: two runs differ")
        err = (got - ref).abs().max().item()
        ring_err = err if d == 2 else ring_err
        n = 50000 // d
        print(f"  ring sums at kitti, d={d}: max |kernel - plain| {err:.3g}, "
              f"max |kernel - tri| {(got - deg_tri).abs().max().item():.3g} "
              f"(step {degree_plan_str(2, n, n)})", flush=True)
    # Bench shapes, d = 2: the ring sums against the direct-form route.
    _build.reset_launches()
    direct = kcompat.degrees(P, Q, P, Q, fast, mxu=False)
    check(_build.launches()["compat_degrees_direct"] == 1
          and _build.launches()["compat_degrees"] == 0, "degrees(mxu=False) took another route")
    torch.testing.assert_close(direct, kcompat.degrees_reference(P, Q, P, Q, fast),
                               rtol=1e-5, atol=1e-3)
    bench_ring, bench_blocks = ring_sums(P, Q, fast, 2, kring.ring_degrees_step)
    torch.testing.assert_close(bench_ring, direct, rtol=1e-5, atol=1e-3)

    # The one loop: a ring step at d = 1 over the rank's own block adds its
    # row sums to a zeroed deg, so it gives the direct route's bits; the sum
    # order is fixed by C alone, so plans of other split counts agree too.
    def ring_d1(Pb, Qb, params):
        return kring.ring_degrees_step(kring.pack_block(Pb, Qb),
                                       kring.pack_block(Pb, Qb),
                                       torch.zeros(Pb.shape[:2], device=dev), 0, 0, params)

    check(torch.equal(ring_d1(P, Q, fast), direct),
          "ring step at d=1 differs from the direct route at the bench point")
    # The direct route at the shape SP hands it in phase 9 (d): the 3DMatch
    # point's second half of the rows against all 2,048 columns.
    h = 1024
    sp_args = (P3[:, h:], Q3[:, h:], P3, Q3, tdm)
    sp_direct = kcompat.degrees(*sp_args, row_offset=h, mxu=False)
    sp_ref = kcompat.degrees_reference(*sp_args, row_offset=h)
    torch.testing.assert_close(sp_direct, sp_ref, rtol=1e-5, atol=1e-3)
    full3 = kcompat.degrees(P3, Q3, P3, Q3, tdm, mxu=False)
    check(torch.equal(sp_direct, full3[:, h:]),
          "direct route: the SP row slice differs from the full call's rows")
    # Other grids than degree_plan's: 1 and 2 rows a thread, 1, 3 and 8 splits.
    for rows3, splits3 in ((1, 1), (2, 1), (1, 3), (2, 8)):
        other = kcompat.DegreePlan(batch=32, rows=rows3, tiles=-(-2048 // (128 * rows3)),
                                   splits=splits3, segments=8)
        check(torch.equal(kcompat._two_sided(P3, Q3, P3, Q3, tdm, 0, None, None,
                                             "compat_degrees_direct", plan=other), full3),
              f"direct route: the plan {plan_str(other)} changes the bits")
    part3 = kcompat.degrees(P3[:8], Q3[:8], P3[:8], Q3[:8], tdm, mxu=False)
    check(torch.equal(part3, full3[:8]),
          "direct route: a batch slice differs from the full call's pairs")
    check(torch.equal(ring_d1(P3, Q3, tdm), full3),
          "ring step at d=1 differs from the direct route at the 3DMatch point")
    kdirect = kcompat.degrees(PK, QK, PK, QK, kp, mxu=False)
    check(torch.equal(ring_d1(PK, QK, kp), kdirect),
          "ring step at d=1 differs from the direct route at kitti")
    print(f"  one loop: SP row slice ({degree_plan_str(32, 2048 - h, 2048)}) and batch slice "
          f"({degree_plan_str(8, 2048, 2048)}) bit-identical to the full call "
          f"({degree_plan_str(32, 2048, 2048)}), as are its grids of 1 or 2 rows and 1, 3 or "
          "8 splits; ring step at d=1 bit-identical to the "
          f"direct route at the bench ({degree_plan_str(128, 1000, 1000)}), 3DMatch and "
          f"kitti ({degree_plan_str(2, 50000, 50000)}) points", flush=True)
    row("compat_degrees_direct", "saccot_tpu_torch/csrc/compat_degrees.cu",
        "saccot_tpu/kernels/compat.py:53", (sp_direct - sp_ref).abs().max().item(),
        time_ms(lambda: kcompat.degrees(*sp_args, row_offset=h, mxu=False)),
        time_ms(lambda: kcompat.degrees_reference(*sp_args, row_offset=h)),
        "compat_degrees_direct", degrees_cost(32, 2048 - h, 2048),
        device_ms=kernel_device_ms(lambda: kcompat.degrees(*sp_args, row_offset=h, mxu=False)),
        plan=degree_plan_str(32, 2048 - h, 2048))
    # One step at kitti d = 2 (25,000 x 25,000 per pair) and at the bench, d = 2.
    _, kblocks = ring_sums(PK, QK, kp, 2, kring.ring_degrees_step)
    scratch = torch.zeros((2, 25000), device=dev)
    step_args = (kblocks[0], kblocks[1], scratch, 0, 25000, kp)
    bench_scratch = torch.zeros((128, 500), device=dev)
    bench_step = (bench_blocks[0], bench_blocks[1], bench_scratch, 0, 500, fast)
    bench_ms = time_ms(lambda: kring.ring_degrees_step(*bench_step))
    bench_plain_ms = time_ms(lambda: kring.ring_degrees_step_reference(*bench_step))
    row("ring_degrees", "saccot_tpu_torch/csrc/ring_degrees.cu",
        "saccot_tpu/kernels/ring_compat.py:53", ring_err,
        time_ms(lambda: kring.ring_degrees_step(*step_args), reps=10),
        time_ms(lambda: kring.ring_degrees_step_reference(*step_args), **big), "ring_degrees",
        (PAIR_OPS * 2 * 25000 * 25000, 2 * 28 * 2 * 25000 + 8 * 2 * 25000),
        device_ms=kernel_device_ms(lambda: kring.ring_degrees_step(*step_args)),
        plan=degree_plan_str(2, 25000, 25000))
    print(f"  ring_degrees step at the bench, d=2: kernel {bench_ms:.4f} ms, "
          f"plain {bench_plain_ms:.4f} ms, bound {bound_ms(PAIR_OPS * 128 * 500 * 500, 0)[0]:.4f} "
          f"ms (operations); {degree_plan_str(128, 500, 500)}", flush=True)
    print("phase 8 ok", flush=True)

    # -- phase 9: the distributed estimator on two ranks --------------------
    from saccot_tpu_torch.dist.local import run_ranks

    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    t0 = time.perf_counter()
    ranks = run_ranks(phase9_rank, 2, backend, fast, exact, KITTI_PARAMS, tdm, timeout=600)
    print(f"  {backend}, world size 2, ranks on " + ", ".join(
        f"rank {r['rank']}: cuda:{r['device']} {r['card']}" for r in ranks)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    if backend == "gloo":
        print(f"  gloo on CUDA tensors: {ranks[0]['gloo_cuda']}", flush=True)
    # (a) DP: every pair as in the single-rank batch, inliers within 1 and
    # rotation within 0.05 deg (the refine's torch sums may differ in order).
    for name in ("fast", "exact"):
        one = results[name]
        T1 = one.T.cpu().numpy().astype(np.float64)
        for r in ranks:
            dp = r[f"dp_{name}"]
            check(np.abs(dp.num_inliers.astype(np.int64)
                         - one.num_inliers.cpu().numpy()).max() <= 1,
                  f"DP {name}: inliers differ by more than 1")
            worst = max(rot_deg(dp.T[b], T1[b]) for b in range(128))
            check(worst < 0.05, f"DP {name}: rotation {worst} deg from the single rank")
        print(f"  (a) DP {name}: 128 pairs, worst rotation {worst:.3g} deg from one rank",
              flush=True)
    # (b) TP: the transform bit for bit.
    for r in ranks:
        check(np.array_equal(r["tp"].T, results["fast"].T.cpu().numpy()),
              "TP: transforms differ from the single rank")
    print("  (b) TP fast: T bit-identical to one rank on both ranks", flush=True)
    # (c) SP with the ring at kitti.
    T_one = kitti_results["exact"].T.cpu().numpy().astype(np.float64)
    for r in ranks:
        sp = r["sp_ring"]
        rec = recall_np(sp.T, TK, rot_deg_k, trans_m)
        check(rec == 1.0, f"SP ring: recall {rec}")
        check(all(abs(int(n) - planted) <= 0.01 * planted for n in sp.num_inliers),
              f"SP ring: inliers {sp.num_inliers} not within 1% of {planted}")
        worst = max(rot_deg(sp.T[b], T_one[b]) for b in range(2))
        check(worst < 0.1, f"SP ring: rotation {worst} deg from the single rank")
        check(r["sp_ring_launches"]["ring_degrees"] == 2,
              f"SP ring: {r['sp_ring_launches']['ring_degrees']} ring steps, want 2")
    print(f"  (c) SP ring kitti: recall 1.0, inliers {ranks[0]['sp_ring'].num_inliers.tolist()}, "
          f"worst rotation {worst:.3g} deg from one rank, "
          f"{max(r['sp_ring_ms_per_pair'] for r in ranks):.3f} ms/pair"
          + (" (both ranks share one card)" if backend == "gloo" else ""), flush=True)
    # (d) SP without the ring at the 3DMatch point.
    for r in ranks:
        rec = recall_np(r["sp_3dm"].T, T3, 15.0, 0.30)
        check(abs(rec - rec_k) <= 1 / 32, f"SP 3DMatch: recall {rec}, one rank {rec_k}")
        check(r["sp_3dm_launches"]["compat_degrees_direct"] == 1,
              "SP 3DMatch: the direct-form degree route was not taken")
    print(f"  (d) SP 3DMatch: recall {rec:.4f} (one rank {rec_k:.4f})", flush=True)
    dist_launches = {k: sum(r[f"{case}_launches"][k] for r in ranks for case in
                            ("sp_ring", "sp_3dm")) for k in _build.LAUNCHES}
    print(f"  launches summed over ranks (SP runs): {dist_launches}", flush=True)
    for r in rows:
        if "counter" in r:
            r["launches"] = dist_launches[r.pop("counter")]
            check(r["launches"] > 0, f"{r['name']} was not launched by the distributed runs")
    print("phase 9 ok", flush=True)

    # -- phase 10: the degree loop's per-operation attribution (row 11) ------
    from saccot_tpu_torch.kernels import compat_ops as kops
    from saccot_tpu_torch.scripts import exp_compat_ops as xops

    def hold_variant(Pv, Qv, got, ref, mode, rtol, what):
        """Kernel row sums against the plain ones: rtol of the row sum (of the
        sum of |p_i||p_j| + |q_i||q_j| in gram_only, whose terms take both
        signs), plus atol 2e-3 in the threshold modes as the degree rows."""
        atol = 2e-3 if mode in ("no_sqrt_tail", "full") else 0.0
        if mode == "gram_only":
            atol = rtol * kops.variant_degrees_reference(
                Pv.abs(), Qv.abs(), kp, mode, "two_sided").max().item()
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
        print(f"  compat_ops {what}: max |kernel - plain| {(got - ref).abs().max().item():.4g} "
              f"(rtol {rtol:g}, atol {atol:.3g})", flush=True)
        return (got - ref).abs().max().item()

    # Each mode x form kernel against its plain version of the same form at
    # N=3,000 (the ragged edge: 3,000 is no multiple of 128 or 256), rtol
    # 1e-5: the same operations on each pair, row sums in another order.
    P1, Q1, _ = kitti_problem_batch([KITTI_SEED], device=dev, n=3000)
    print(f"  two-sided form at N=3000: {degree_plan_str(1, 3000, 3000)}; at N=50000: "
          f"{degree_plan_str(1, 50000, 50000)}", flush=True)
    for form in kops.FORMS:
        for mode in kops.MODES:
            hold_variant(P1, Q1, kops.variant_degrees(P1, Q1, kp, mode, form),
                         kops.variant_degrees_reference(P1, Q1, kp, mode, form), mode, 1e-5,
                         f"{form}/{mode} at N=3000")
    # On the script's pair (N=50,000), the size the attribution times, every
    # mode x form kernel against the two-sided plain version (about 0.2 s a
    # call; tests/test_torch_exp_compat_ops.py holds the tri plain version
    # to it). The tri kernel adds 128-term tile sums over 391 tiles: rtol
    # 1e-5. The two-sided kernel adds 50,000 terms one after another, whose
    # rounding errors grow as sqrt(n) u on average (n = 50,000, u = 2^-24:
    # 1.3e-5 of the sum of the terms' magnitudes): rtol 4 sqrt(n) u =
    # 5.3e-5. `full` is the degree: bit for bit the production kernel of its
    # form.
    PX, QX, _ = kitti_problem_batch([KITTI_SEED], device=dev)
    rtol_x = {"tri": 1e-5, "two_sided": 4 * 50000 ** 0.5 * 2.0 ** -24}
    full_err = {}
    for mode in kops.MODES:
        ref = kops.variant_degrees_reference(PX, QX, kp, mode, "two_sided")
        for form in kops.FORMS:
            got = kops.variant_degrees(PX, QX, kp, mode, form)
            err = hold_variant(PX, QX, got, ref, mode, rtol_x[form], f"{form}/{mode} at N=50000")
            if mode == "full":
                full_err[form] = err
                prod = (kcompat.degrees_tri(PX, QX, kp) if form == "tri" else
                        kcompat.degrees_two_sided(PX, QX, PX, QX, kp))
                check(torch.equal(got, prod),
                      f"compat_ops {form}/full differs from the production kernel at N=50000")
    print("  compat_ops full: bit-identical to compat_degrees_tri and to the two-sided "
          "kernel at N=50000", flush=True)
    plain_ms = {form: time_ms(lambda: kops.variant_degrees_reference(PX, QX, kp, "full", form),
                              reps=3, warmup=1)
                for form in kops.FORMS}
    full_device_ms = {form: kernel_device_ms(lambda: kops.variant_degrees(PX, QX, kp, "full", form),
                                             reps=5)
                      for form in kops.FORMS}
    # The script's path at N=50,000, counted.
    torch.cuda.synchronize()
    _build.reset_launches()
    attr = xops.attribution(PX, QX, kp)
    torch.cuda.synchronize()
    ops_launches = _build.launches()
    print(json.dumps({"compat_ops": {f"{r['form']}/{r['mode']}": r["ms"] for r in attr}}))
    for r in attr:
        print(f"  {r['form']:9s} {r['mode']:13s} {r['ms']:.4f} ms, {r['ops_per_pair']} ops/pair, "
              f"bound {r['bound_ms']:.4f} ms, over d2_only {r['over_d2_ms']:+.4f} ms", flush=True)
    for form in kops.FORMS:
        n = ops_launches[f"compat_ops_{form}"]
        check(n > 0, f"compat_ops {form} was not launched by the attribution run")
        b_ms, b_by = bound_ms(*xops.cost("full", form, 1, 50000))
        rows.append(dict(
            name=f"compat_ops_{form}", route="cuda", source="saccot_tpu_torch/csrc/compat_ops.cu",
            replaces="scripts/exp_compat_ops.py:40", launches=n, max_abs_err=full_err[form],
            ms=next(r["ms"] for r in attr if r["form"] == form and r["mode"] == "full"),
            plain_ms=plain_ms[form], bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=full_device_ms[form],
            mode_ms={r["mode"]: r["ms"] for r in attr if r["form"] == form}))
    print(f"phase 10 ok: launches {ops_launches}", flush=True)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
