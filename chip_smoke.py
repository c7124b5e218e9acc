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
     and each kernel's device time from the profiler; the fused anchor
     kernel's selections bit for bit against the streamed kernel's (column
     chunks of 256) and its top-T mode against
     `candidate_topt` on its own selections (`hold_anchor`); score's counts
     identical to the plain version's, its weighted mode within the stated
     tolerance, bit-identical across two calls and for half the hypotheses
     scored alone (`hold_score`); the warps per block of the anchor kernel
     and the point splits of the score kernel at each shape, and the
     two-sided degree loop's `degree_plan` (rows a thread, column splits)
     at every degree shape of phases 3, 6, 8 and 10; the solve bit for bit
     against its plain version, with its `solve_plan`;
  4. `register_batch` at the bench point (128 planted pairs, seeds 1000+s,
     80% outliers, noise 0.004) in the fast and the exact configuration:
     recall under the 5 deg / 0.05 criterion, launch counts of every kernel
     during that run, and pairs/s; then with `scoring="weighted"` through
     the kernels and the plain versions (`hold_weighted`): the same recall,
     inliers within 1, and the hypothesis each picks on the kernel route's
     pool, any flip printed with its margin (at most twice the weighted
     score's tolerance);
  5. the 3DMatch sweep point (32 pairs, seeds 300+s, N=2048, 90% outliers,
     noise 0.01, exact configuration, 15 deg / 0.30 criterion) through the
     kernels and through the plain versions on the card; the fused anchor
     and score kernels at its shapes (256 anchors, B=16, N=2048; 2,048
     hypotheses a pair), held as in phase 3;
  6. the large-N kernels against their plain versions at the kitti shapes
     (batch 2, N=50,000, A=512, B=16, T=4, K=2048): the symmetric degree
     kernel (also bit-identical across two calls, and against the two-sided
     kernel), the streamed top-B (also bit-identical across two calls and
     for each half of the anchors run alone, and to the fused kernel at
     N=3,000 under three plans, with and without masks: one chunk, chunks of
     1,024, and chunks of 7 columns, fewer than B); the card's launch floor
     (an empty kernel, one thread); the candidate top-T under every W of
     its sweep (the same bits, also for each half of the anchors alone, and
     at N=3,000 the fused kernel's top-T mode's, with and without masks);
     the solve bit for bit under every block size of its sweep at kitti
     and the bench point, and the score kernel at N=50,000, held as in
     phase 3 there and at the SP shard's 25,000 points;
  7. `register_batch` at the kitti configuration (seeds 500-501, 70%
     outliers, 5 deg / 0.6 m criterion), exact and fast variant, through the
     kernels and through the plain versions: recall, inliers per pair, ms per
     pair and the launch counts of every kernel during the kernel runs;
     weighted scoring held as in phase 4;
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
     counts, and one {"compat_ops": {...}} line of the ten times;
 11. the cloud pipeline at the bunny configuration (`register_clouds_batch`
     on 4 two-view pairs of 8,192 points a view, ISS + SHOT, estimator
     A=192, B=12, K=512): recall 1.0 under 5 deg / 0.05 on the kernel
     route with launches of rows 1-4 counted; rows 1-4 against their plain
     versions on the path's own masked correspondence sets ([4, 1024, 3],
     as phase 3 holds them); the plain route picks the same keypoints and
     correspondences and a transform within 0.1 deg; a repeat call, and
     one with TF32 allowed, give the same bits; one pair with the trimmed
     point-to-point ICP polish; host and device ms of each stage a pair
     from the stages' profiler ranges in the timed calls, and one
     {"bunny_pipeline": {...}} line with the launches per pair and the
     device's idle share;
 12. sequence SLAM and the sampler ablation: `run_sequence` at the slam
     configuration (10 scans, 13 edges of N=512, A=128, B=12, K=512; 10 PGO
     steps dense, track BA of 5 steps on up to 2,048 landmarks) by the
     kernel and the plain route: all 13 edges registered, the same BA track
     stats, final poses within 1e-3, ATE < 0.05, a repeat call bit for bit,
     rows 1-4's launches counted, host and device ms of each stage from the
     profiler ranges `slam/<stage>`; the same at 128 scans (170 edges, PGO
     by PCG): the same edges registered, poses within 1e-3; the JAX tests'
     scale points (PGO by PCG at M=256, BA at M=128, L=4,096) within their
     bounds; the sampler ablation at the recorded points (16 pairs, N=1,000,
     K = 128 and 512, 80/90/95% outliers) by both routes: recall saccot >=
     edge >= random on the kernel route, saccot equal by route, edge and
     random within 1/16, rows 1-4's launches counted; the sharded BA and PGO
     dry runs on two spawned ranks, each within 2e-4 of one rank; one
     {"slam": {...}} line of the readings.
Each kernel row carries its bound: the larger of its FP32 operations over
the card's FP32 instruction rate and its bytes over the memory rate
(`bound_ms`, from the attribution script), and its device ms over the
launch floor (`device_over_floor`). The line before the last is a
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


def solve_plan_str(batch, K):
    """`solve_plan` of batch x K hypotheses on card 0."""
    import torch

    from saccot_tpu_torch.kernels import solve3 as ksolve

    plan = ksolve.solve_plan(batch, K, ksolve.sm_count(torch.device("cuda", 0)))
    return f"{plan_str(plan)}, {plan.blocks} blocks"


def hold_anchor(P, Q, anchors, B, T, tau, sep, where, mask=None, anchor_mask=None):
    """The fused anchor kernel in both modes against its plain version, its
    selections bit for bit against the streamed kernel's over many column
    chunks (256 columns each) and its top-T against `candidate_topt` on its
    own selections; every call with the column and anchor masks given.
    Returns the worst error of each mode."""
    import torch

    from saccot_tpu_torch.kernels import triangles as ktri

    mkw = dict(mask=mask, anchor_mask=anchor_mask)
    stream = ktri.anchor_neighbors_stream(P, Q, anchors, B, tau, sep, chunk_n=256, **mkw)
    errs = {}
    for mode, kw in (("candidates", {"emit_candidates": True}), ("topt", {"top_t": T})):
        got = ktri.anchor_neighbors(P, Q, anchors, B, tau, sep, **mkw, **kw)
        ref = ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep, **mkw, **kw)
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
            ct = ktri.candidate_topt(got[0], got[1], P, Q, T, tau, sep)
            check(all(torch.equal(x, y) for x, y in zip(ct, got[2:])),
                  f"anchor_topb topt at {where} differs from candidate_topt on its selections")
        # The whole row against 256-column chunks merged: bit for bit, since
        # the key is a total order.
        check(torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1]),
              f"anchor_topb {mode} at {where}: selections differ from anchor_neighbors_stream")
        errs[mode] = max(err_s, err_c)
    A, N = anchors.shape[1], P.shape[1]
    plan = ktri.anchor_plan(N, B)
    print(f"  anchor_topb at {where} (batch {P.shape[0]}, N={N}, A={A}, B={B}, "
          f"masked {mask is not None}): {plan_str(plan)}, {-(-A // plan.warps)} blocks a pair; "
          "scores within 1e-6 of plain; selections bit-identical to "
          "anchor_neighbors_stream(chunk_n=256), top-T to candidate_topt", flush=True)
    return errs


def hold_score(r9, t3, P, Q, tau, where, mask=None):
    """The score kernel against its plain version, both with the point mask
    given. Counts identical for every hypothesis (each operation of the
    residual rounded on its own, as the plain version does: no FMA),
    count-mode scores equal to them. Weighted scores within
    `weighted_rtol(N)` of the plain version (the same terms, bit for bit,
    summed in another order), the same bits in two calls and for the second
    half of the hypotheses scored alone, a tensor-parallel rank's share (the
    kernel's order of the sums depends on N alone)."""
    import torch

    from saccot_tpu_torch.kernels import score as kscore

    batch, _, K = r9.shape
    N = P.shape[1]
    s, c = kscore.score_hypotheses(r9, t3, P, Q, tau, mask=mask)
    rc = kscore.score_hypotheses_reference(r9, t3, P, Q, tau, mask=mask)[1]
    diff = (c - rc).abs()
    check(diff.max().item() == 0, f"score at {where}: counts identical for "
          f"{(diff == 0).float().mean().item():.5f}, max diff {diff.max().item()}")
    check(torch.equal(s, c.float()), f"score at {where}: count-mode scores are not the counts")
    ws, wc = kscore.score_hypotheses(r9, t3, P, Q, tau, mask=mask, mode="weighted")
    wr = kscore.score_hypotheses_reference(r9, t3, P, Q, tau, mask=mask, mode="weighted")[0]
    check(torch.equal(wc, rc), f"score weighted at {where}: counts differ")
    rtol = kscore.weighted_rtol(N)
    torch.testing.assert_close(ws, wr, rtol=rtol, atol=0.0)
    check(torch.equal(ws, kscore.score_hypotheses(r9, t3, P, Q, tau, mask=mask,
                                                  mode="weighted")[0]),
          f"score weighted at {where}: two calls differ")
    h = K // 2
    half = kscore.score_hypotheses(r9[:, :, h:].contiguous(), t3[:, :, h:].contiguous(), P, Q,
                                   tau, mask=mask, mode="weighted")[0]
    check(torch.equal(half, ws[:, h:]),
          f"score weighted at {where}: hypotheses {h}.. scored alone differ")
    sms = torch.cuda.get_device_properties(P.device).multi_processor_count
    print(f"  score at {where} (batch {batch}, K={K}, N={N}): "
          f"{plan_str(kscore.score_plan(batch, K, N, sms))}; counts identical; weighted "
          f"max |kernel - plain| {(ws - wr).abs().max().item():.4g} (rtol {rtol:.3g}), "
          f"bit-identical across two calls and for hypotheses {h}.. alone "
          f"({plan_str(kscore.score_plan(batch, K - h, N, sms))})", flush=True)


def hold_weighted(P, Q, params, T_gt, criterion, where):
    """`register_batch(..., scoring="weighted")` through the kernels and the
    plain versions: the same recall and inlier counts within 1. Then the pick
    itself, on the kernel route's pool and solves: the hypothesis of highest
    weighted score by the score kernel and by its plain version. A flip (a
    pair where they differ) is printed with its margin, the plain scores'
    gap between the two picks relative to the larger. Each side is within
    `weighted_rtol(N)` of the plain score, so a flip can only fall between
    hypotheses whose plain scores lie within 2 rtol of each other; one
    further apart fails."""
    import torch

    from saccot_tpu_torch import register_batch
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import score as kscore
    from saccot_tpu_torch.kernels import solve3 as ksolve
    from saccot_tpu_torch.utils.convert import recall

    pw = dataclasses.replace(params, scoring="weighted")
    got = register_batch(P, Q, pw)
    ref = register_batch(P, Q, pw, impl="plain")
    rec_k, rec_p = recall(got, T_gt, *criterion), recall(ref, T_gt, *criterion)
    check(rec_k == rec_p, f"weighted at {where}: recall kernels {rec_k}, plain {rec_p}")
    dn = (got.num_inliers - ref.num_inliers).abs().max().item()
    check(dn <= 1, f"weighted at {where}: inlier counts differ by {dn}")
    deg = kcompat.degrees(P, Q, P, Q, params)
    pool = tri_mod.triangle_pool_from_points(P, Q, deg, pw)
    r9, t3 = ksolve.solve3(P, Q, pool.triples)
    args = (r9, t3, P, Q, params.inlier_tau)
    sk = torch.where(pool.valid, kscore.score_hypotheses(*args, mode="weighted")[0], -1.0)
    sp = torch.where(pool.valid, kscore.score_hypotheses_reference(*args, mode="weighted")[0],
                     -1.0)
    pk, pp = sk.argmax(dim=1), sp.argmax(dim=1)
    rtol = kscore.weighted_rtol(P.shape[1])
    flips = []
    for b in (pk != pp).nonzero()[:, 0].tolist():
        hi, lo = sp[b, pp[b]].item(), sp[b, pk[b]].item()
        flips.append(dict(pair=b, kernel=pk[b].item(), plain=pp[b].item(),
                          margin=(hi - lo) / hi))
    print(f"  weighted at {where}: recall {rec_k:.4f} (plain {rec_p:.4f}), inliers within "
          f"{dn}; the pick of {P.shape[0]} pairs: {len(flips)} flips {flips} (rtol {rtol:.3g})",
          flush=True)
    check(all(f["margin"] <= 2 * rtol for f in flips),
          f"weighted at {where}: a flip beyond the kernel's tolerance: {flips}")


def rot_deg(T_a, T_b):
    """Rotation angle in degrees between two 4x4 transforms."""
    import numpy as np

    E = np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64))
    return float(np.degrees(np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))))


def recall_np(T, T_gt, rot_thresh_deg, trans_thresh):
    from saccot_tpu_torch.evaluation.metrics import registration_recall

    return registration_recall(zip(T, T_gt), rot_thresh_deg, trans_thresh)


def hold_path_kernels(P, Q, params, where, key, rows, mask=None, samples=()):
    """Rows 1-4 against their plain versions on the inputs that a path hands
    them: its correspondence sets P, Q [batch, N, 3] (with their mask, as
    `register_batch` passes it, mask_rows and mask_cols the same tensor: at
    N <= 2048 the two-sided kernel, row 1) and its estimator parameters; at
    phase 3's tolerances (degrees rtol 1e-5 / atol 1e-3, masked rows 0; the
    anchor kernel as `hold_anchor`; the solve bit for bit; counts as
    `hold_score`). `samples`: further (name, triples [batch, K, 3]) that the
    path solves and scores, each held the same way. Adds each row's worst
    error here to its row as `<key>_max_abs_err` (the worst over calls)."""
    import torch

    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import solve3 as ksolve
    from saccot_tpu_torch.kernels import triangles as ktri

    batch, N, _ = P.shape
    deg = kcompat.degrees(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    deg_ref = kcompat.degrees_reference(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    torch.testing.assert_close(deg, deg_ref, rtol=1e-5, atol=1e-3)
    if mask is not None:
        check(bool((deg[mask == 0] == 0).all()),
              f"compat_degrees at {where}: a masked row has a degree")
    A, B = min(params.num_anchors, N), min(params.neighbors_per_anchor, N - 1)
    _, anchors = ktri.topk_stable(deg_ref, A)
    anchor_err = hold_anchor(P, Q, anchors, B, 4, params.compat_tau, params.min_separation,
                             where, mask=mask,
                             anchor_mask=None if mask is None else torch.gather(mask, 1, anchors))
    pool = tri_mod.triangle_pool_from_points(P, Q, deg_ref, params, mask=mask, impl="plain")
    for name, triples in (("the estimator's pool", pool.triples),) + tuple(samples):
        r9, t3 = ksolve.solve3(P, Q, triples)
        r9_ref, t3_ref = ksolve.solve3_reference(P, Q, triples)
        check(torch.equal(r9, r9_ref) and torch.equal(t3, t3_ref),
              f"solve3 at {where} on {name}: r9/t3 differ")
        hold_score(r9_ref, t3_ref, P, Q, params.inlier_tau, f"{where} ({name})", mask=mask)
    errs = {"compat_degrees": (deg - deg_ref).abs().max().item(),
            "anchor_topb_candidates": anchor_err["candidates"],
            "anchor_topb_topt": anchor_err["topt"], "solve3": 0.0, "score": 0.0}
    for r in rows:
        if r["name"] in errs:
            r[f"{key}_max_abs_err"] = max(r.get(f"{key}_max_abs_err", 0.0), errs[r["name"]])
    valid = "all" if mask is None else mask.sum(dim=1).int().tolist()
    print(f"  rows 1-4 at {where} (batch {batch}, N={N}, valid rows {valid}, A={A}, B={B}, "
          f"K={pool.triples.shape[1]}, solved and scored: the pool"
          + "".join(f", {name}" for name, _ in samples) + "): degrees within "
          f"{errs['compat_degrees']:.3g} of plain, solve bit for bit, counts identical",
          flush=True)


def hold_bunny_kernels(res, cfg, rows):
    """Rows 1-4 on the inputs the bunny path hands them: the correspondence
    sets of a `register_clouds_batch` result in pr units with their mask
    ([4, 1024, 3], most rows masked), the estimator's parameters
    (`pipeline_max_abs_err`)."""
    from saccot_tpu_torch.features import pipeline as fp

    P, Q = fp.pr_units(res.corr_P, res.resolution), fp.pr_units(res.corr_Q, res.resolution)
    hold_path_kernels(P, Q, fp.estimator_params(cfg), "the bunny path", "pipeline", rows,
                      mask=res.corr_mask)


def hold_slam_kernels(seq, dev, rows):
    """Rows 1-4 on the inputs `run_sequence` hands them at the slam
    configuration: the 13 edges' correspondence sets (N=512, no mask) under
    SLAM_PARAMS (`slam_max_abs_err`)."""
    import torch

    from saccot_tpu_torch.slam import frontend as fe

    P = torch.as_tensor(seq["edge_P"], device=dev).float()
    Q = torch.as_tensor(seq["edge_Q"], device=dev).float()
    hold_path_kernels(P, Q, fe.SLAM_PARAMS, "the slam configuration", "slam", rows)


def hold_ablation_kernels(dev, rows):
    """Rows 1-4 on the inputs the sampler ablation hands them, at each
    (K, outlier ratio): the cell's 16 problems (N=1000, no mask) under
    OBJ_PARAMS at budget K, and besides the estimator's pool the RANSAC
    triples (top 3 of the pairs' priority fields) and the edge-guided
    triples (top-K anchor-row edges completed at random) that the baselines
    solve and score (`ablation_max_abs_err`)."""
    import torch

    from saccot_tpu_torch.engine import baselines as base
    from saccot_tpu_torch.evaluation import ablation as abl
    from saccot_tpu_torch.kernels import compat as kcompat

    for K in abl.ABLATION_BUDGETS:
        params = dataclasses.replace(abl.OBJ_PARAMS, max_hypotheses=K)
        for ratio in abl.ABLATION_RATIOS:
            P, Q, _, seeds = abl.ablation_problems(ratio, abl.ABLATION_PAIRS, 1000, 0.004, 0, dev)
            batch, N, _ = P.shape
            m = torch.ones((batch, N), dtype=torch.float32, device=dev)
            u = base.priority_field(seeds, batch, K, N, dev)
            random = base._random_triples(u, mask=m)
            edge = base._edge_triples(P, Q, m, None, params, u, kcompat.degrees)[0]
            hold_path_kernels(P, Q, params, f"the ablation (K={K}, {ratio:.0%} outliers)",
                              "ablation", rows,
                              samples=(("RANSAC's triples", random), ("edge triples", edge)))


def stage_lines(ranges, pairs, what):
    """Print the profiler ranges of the pipeline's stages a pair: host ms
    and device ms, each range's totals over `pairs`."""
    for name, v in ranges.items():
        print(f"  {what} {name}: {v['calls'] / pairs:g} entries, host {v['host_ms'] / pairs:.3f} "
              f"ms, device {v['device_ms'] / pairs:.3f} ms a pair", flush=True)


def phase11(dev, rows):
    """The cloud pipeline at the bunny configuration: `register_clouds_batch`
    on the 4 bunny pairs (seeds 9-12, 8,192 points a view), ISS + SHOT,
    A=192, B=12, K=512, exact config: the feature stages pair by pair, then
    one `register_batch` call on the [4, 1024, 3] correspondence sets
    (rows 1-4). Counted on the kernel route, then the plain route on the
    same clouds; rows 1-4 held to their plain versions on the path's own
    inputs. Adds each of rows 1-4's launches in this run to its row. Stage
    times come from the profiler ranges of the timed calls."""
    import numpy as np
    import torch

    from saccot_tpu_torch.engine.icp import IcpParams
    from saccot_tpu_torch.features import pipeline as fp
    from saccot_tpu_torch.features.pipeline import (
        BUNNY_CRITERION, BUNNY_N_POINTS, BUNNY_PAIRS, BUNNY_PIPE, BUNNY_SEED, bunny_pairs,
    )
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.utils.profile import profile_call

    seeds = range(BUNNY_SEED, BUNNY_SEED + BUNNY_PAIRS)
    src, tgt, Tb = bunny_pairs(seeds, device=dev)
    check(src.shape == tgt.shape == (BUNNY_PAIRS, BUNNY_N_POINTS, 3),
          f"bunny clouds {tuple(src.shape)}, {tuple(tgt.shape)}")
    plain_cfg = dataclasses.replace(BUNNY_PIPE, impl="plain")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    bk = fp.register_clouds_batch(src, tgt, BUNNY_PIPE, device=dev)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    pipe_launches = _build.launches()
    for name in ("compat_degrees", "anchor_topb_candidates", "solve3", "score"):
        check(pipe_launches[name] > 0, f"{name} was not launched by register_clouds_batch")
    for r in rows:
        if r["name"] in ("compat_degrees", "anchor_topb_candidates", "solve3", "score"):
            r["pipeline_launches"] = pipe_launches[r["name"]]
    hold_bunny_kernels(bk, BUNNY_PIPE, rows)
    t0 = time.perf_counter()
    bp = fp.register_clouds_batch(src, tgt, plain_cfg, device=dev)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    Tk, Tp = bk.registration.T.cpu().numpy(), bp.registration.T.cpu().numpy()
    check(np.isfinite(Tk).all() and Tk.shape == (BUNNY_PAIRS, 4, 4),
          "bunny: non-finite or misshapen transforms")
    rec = recall_np(Tk, Tb, *BUNNY_CRITERION)
    check(rec == 1.0, f"bunny: recall {rec} < 1.0 on the kernel route")
    # The feature stages are shared: the same keypoints and correspondences
    # bit for bit; the two estimator routes within 0.1 deg.
    for name in ("num_keypoints_src", "num_keypoints_tgt", "num_correspondences"):
        check(torch.equal(getattr(bk, name), getattr(bp, name)), f"bunny: {name} differ by route")
    check(all(torch.equal(getattr(bk, f), getattr(bp, f)) for f in ("corr_P", "corr_Q", "corr_mask")),
          "bunny: the routes matched different correspondences")
    route_deg = [rot_deg(Tk[b], Tp[b]) for b in range(BUNNY_PAIRS)]
    check(max(route_deg) < 0.1, f"bunny: kernel and plain transforms differ by {route_deg} deg")
    again = fp.register_clouds_batch(src, tgt, BUNNY_PIPE, device=dev)
    check(all(torch.equal(a, b) for a, b in zip(
        (bk.registration.T, bk.registration.inliers, bk.corr_P, bk.corr_Q, bk.resolution),
        (again.registration.T, again.registration.inliers, again.corr_P, again.corr_Q,
         again.resolution))), "bunny: a repeat call gave other bits")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fp.register_clouds_batch(src, tgt, BUNNY_PIPE, device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(tf32.registration.T, bk.registration.T) and torch.equal(tf32.corr_P, bk.corr_P),
          "bunny: TF32 allowed for matmuls changed the bits")
    errs = [recall_np(Tk[b:b + 1], Tb[b:b + 1], *BUNNY_CRITERION) for b in range(BUNNY_PAIRS)]
    print(f"  bunny: recall kernels {rec:.2f}, plain {recall_np(Tp, Tb, *BUNNY_CRITERION):.2f}, "
          f"rotation errors {[round(rot_deg(Tk[b], Tb[b]), 4) for b in range(BUNNY_PAIRS)]} deg, "
          f"kernel vs plain {[round(d, 6) for d in route_deg]} deg, registered {errs}", flush=True)
    print(f"  bunny: keypoints {bk.num_keypoints_src.tolist()} / {bk.num_keypoints_tgt.tolist()}, "
          f"correspondences {bk.num_correspondences.tolist()}, inliers "
          f"{bk.registration.num_inliers.tolist()}, pr {bk.resolution.tolist()}", flush=True)
    print(f"  bunny: first call {first_ms:.1f} ms (kernels), plain route {plain_ms:.1f} ms; "
          f"launches {pipe_launches}", flush=True)
    # The ICP polish, trimmed point-to-point in pr units, on the first pair.
    icp_cfg = dataclasses.replace(BUNNY_PIPE, icp=IcpParams(max_iters=10, max_corr_dist=6.0,
                                                            trim_frac=0.8))
    pol = fp.register_clouds(src[0], tgt[0], icp_cfg, device=dev)
    Ti = pol.registration.T.cpu().numpy()
    check(np.isfinite(Ti).all() and float(pol.icp_rmse) > 0.0, "bunny ICP: non-finite result")
    check(recall_np(Ti[None], Tb[:1], *BUNNY_CRITERION) == 1.0, "bunny ICP: not registered")
    print(f"  bunny ICP (pair 0): rotation error {rot_deg(Ti, Tb[0]):.4f} deg (coarse "
          f"{rot_deg(Tk[0], Tb[0]):.4f}), rmse {float(pol.icp_rmse):.4f} pr", flush=True)
    # Timed calls (after the runs above warmed up); each stage's host and
    # device ms from its profiler range in the same profile.
    prof = profile_call(lambda: fp.register_clouds_batch(src, tgt, BUNNY_PIPE, device=dev),
                        reps=3, batches=2, ranges=fp.STAGE_PREFIX)
    prof_plain = profile_call(lambda: fp.register_clouds_batch(src, tgt, plain_cfg, device=dev),
                              reps=2, batches=1, ranges=fp.STAGE_PREFIX)
    prof_icp = profile_call(lambda: fp.register_clouds(src[0], tgt[0], icp_cfg, device=dev),
                            reps=2, batches=1, ranges=fp.STAGE_PREFIX)
    staged = sum(v["device_ms"] for v in prof["ranges"].values())
    busy = prof["device_busy_ms_per_batch"]
    print(f"  bunny: the stage ranges hold {staged:.3f} of {busy:.3f} device ms a batch", flush=True)
    check(0.9 * busy <= staged <= 1.001 * busy,
          f"bunny: the stage ranges hold {staged} of {busy} device ms a batch")
    stage_lines(prof["ranges"], BUNNY_PAIRS, "bunny stage")
    stage_lines(prof_icp["ranges"], 1, "bunny stage with ICP, pair 0:")
    print(json.dumps({"bunny_pipeline": dict(
        pairs=BUNNY_PAIRS,
        wall_ms_per_pair=prof["wall_ms_per_batch"] / BUNNY_PAIRS,
        device_busy_ms_per_pair=busy / BUNNY_PAIRS,
        idle_share=prof["idle_share"],
        kernels_per_pair=prof["kernels_per_batch"] / BUNNY_PAIRS,
        stage_ms_per_batch=prof["ranges"],
        own_kernels_ms_per_batch=prof["own_kernels_ms_per_batch"],
        top_kernels=prof["top_kernels"],
        plain_wall_ms_per_pair=prof_plain["wall_ms_per_batch"] / BUNNY_PAIRS,
        plain_idle_share=prof_plain["idle_share"],
        plain_kernels_per_pair=prof_plain["kernels_per_batch"] / BUNNY_PAIRS,
        plain_stage_ms_per_batch=prof_plain["ranges"],
        icp_pair_wall_ms=prof_icp["wall_ms_per_batch"],
        icp_pair_idle_share=prof_icp["idle_share"],
        icp_pair_kernels=prof_icp["kernels_per_batch"],
        icp_pair_stage_ms=prof_icp["ranges"])}), flush=True)
    print(f"phase 11 ok: bunny recall {rec:.2f}, launches {pipe_launches}", flush=True)


# Rows 1-4 as run_sequence and the ablation launch them (the exact
# configuration: row 2 in its candidates mode); the baselines run rows 1, 3
# and 4, the saccot sampler all four.
PATH_ROWS = ("compat_degrees", "anchor_topb_candidates", "solve3", "score")


def slam_route_runs(seq, impl, dev):
    """run_sequence at the slam configuration's arguments (10 PGO steps,
    BA of 5 steps on up to 2,048 landmarks) on `seq`, by `impl`; its wall ms
    (host clock, synchronized) and the kernel launches it made."""
    import torch

    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.slam import frontend as fe

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = fe.run_sequence(n_scans=len(seq["poses_gt"]), edges=seq["edges"], edge_P=seq["edge_P"],
                          edge_Q=seq["edge_Q"], params=fe.SLAM_PARAMS, pgo_iters=10, run_ba=True,
                          ba_iters=5, max_landmarks=2048, impl=impl, device=dev)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, _build.launches()


def hold_slam_routes(k, p, seq, what, same_stats=True):
    """Both routes of one sequence: every edge registered the same way, the
    same BA track stats, final poses within 1e-3; returns the ATEs (PGO and
    final) of each route."""
    import torch

    from saccot_tpu_torch.evaluation.metrics import ate

    E = len(seq["edges"])
    check(torch.equal(k.registration.success, p.registration.success),
          f"{what}: the routes register different edges")
    if same_stats:
        for key in k.ba_stats:
            same = (abs(k.ba_stats[key] - p.ba_stats[key]) <= 1e-6 * abs(p.ba_stats[key])
                    if key == "huber_delta" else k.ba_stats[key] == p.ba_stats[key])
            check(same, f"{what}: BA track stat {key} {k.ba_stats[key]} vs {p.ba_stats[key]}")
    gap = (k.poses - p.poses).abs().max().item()
    check(gap < 1e-3, f"{what}: final poses of the routes {gap} apart")
    out = {}
    for name, res in (("kernel", k), ("plain", p)):
        check(bool(torch.isfinite(res.poses).all())
              and res.poses.shape[0] == seq["poses_gt"].shape[0],
              f"{what}: non-finite or misshapen poses ({name})")
        pgo = res.pose_graph_result.poses.double().cpu().numpy()
        out[name] = dict(
            registered=int(res.registration.success.sum()), edges=E,
            ate_pgo=ate(pgo, seq["poses_gt"])["rmse"],
            ate=ate(res.poses.double().cpu().numpy(), seq["poses_gt"])["rmse"])
    return out, gap


def phase12(dev, rows):
    """Sequence SLAM and the sampler ablation: `run_sequence` at the slam
    configuration (10 scans, 13 edges of N=512, PGO dense, track BA) and at
    128 scans (170 edges, PGO by PCG) by the kernel and the plain route;
    the JAX tests' two scale points (PGO by PCG at M=256, BA at M=128,
    L=4,096); the sampler ablation at the recorded points (16 pairs,
    N=1,000, K in {128, 512}, 80/90/95% outliers) by both routes; the
    sharded BA and PGO dry runs on two spawned ranks. Adds rows 1-4's
    launches in the slam run and in the ablation's kernel-route runs to
    their rows."""
    import numpy as np
    import torch

    from saccot_tpu_torch.dist.local import run_ranks
    from saccot_tpu_torch.evaluation import ablation as abl
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.slam import dryrun, problems
    from saccot_tpu_torch.slam import frontend as fe
    from saccot_tpu_torch.slam.ba import bundle_adjust
    from saccot_tpu_torch.slam.posegraph import optimize_pose_graph
    from saccot_tpu_torch.utils.profile import profile_call

    t_phase = time.perf_counter()
    # (a) The slam configuration, both routes.
    seq = fe.slam_config_sequence()
    k, k_ms, slam_launches = slam_route_runs(seq, "kernel", dev)
    p, p_ms, _ = slam_route_runs(seq, "plain", dev)
    check(len(seq["edges"]) == 13, f"slam: {len(seq['edges'])} edges, want 13")
    ates, gap = hold_slam_routes(k, p, seq, "slam")
    for name, a in ates.items():
        check(a["registered"] == 13, f"slam: {a['registered']} of 13 edges registered ({name})")
        check(a["ate"] < fe.SLAM_ATE_BOUND, f"slam: final ATE {a['ate']} ({name})")
    for name in PATH_ROWS:
        check(slam_launches[name] > 0, f"{name} was not launched by run_sequence")
    for r in rows:
        if r["name"] in PATH_ROWS or r["name"] == "anchor_topb_topt":
            r["slam_launches"] = slam_launches[r["name"]]
    again, _, _ = slam_route_runs(seq, "kernel", dev)
    check(torch.equal(again.poses, k.poses), "slam: a repeat call gave other bits")
    hold_slam_kernels(seq, dev, rows)
    print(f"  slam (10 scans, 13 edges, N=512): registered {ates['kernel']['registered']} / "
          f"{ates['plain']['registered']}; ATE PGO {ates['kernel']['ate_pgo']:.6f} / "
          f"{ates['plain']['ate_pgo']:.6f}, final {ates['kernel']['ate']:.6f} / "
          f"{ates['plain']['ate']:.6f} (kernel / plain); routes {gap:.3g} apart; first call "
          f"{k_ms:.1f} ms (kernels), {p_ms:.1f} ms (plain); BA tracks {k.ba_stats}; launches "
          f"{slam_launches}", flush=True)
    prof = profile_call(lambda: slam_route_runs(seq, "kernel", dev),
                        reps=2, batches=1, ranges=fe.STAGE_PREFIX)
    stage_lines(prof["ranges"], 1, "slam stage")
    staged = sum(v["device_ms"] for v in prof["ranges"].values())
    print(f"  slam: wall {prof['wall_ms_per_batch']:.1f} ms, device busy "
          f"{prof['device_busy_ms_per_batch']:.3f} ms (the stage ranges hold {staged:.3f}), "
          f"idle {prof['idle_share']:.4f}, {prof['kernels_per_batch']:g} kernels a run "
          f"[{time.perf_counter() - t_phase:.1f} s into the phase]", flush=True)

    # (b) 128 scans: PGO above DENSE_PGO_MAX_POSES takes PCG.
    seq128 = fe.slam_config_sequence(128)
    k128, k128_ms, _ = slam_route_runs(seq128, "kernel", dev)
    p128, p128_ms, _ = slam_route_runs(seq128, "plain", dev)
    ates128, gap128 = hold_slam_routes(k128, p128, seq128, "slam at 128 scans", same_stats=False)
    _, again128_ms, _ = slam_route_runs(seq128, "kernel", dev)
    print(f"  slam at 128 scans ({len(seq128['edges'])} edges): registered "
          f"{ates128['kernel']['registered']} / {ates128['plain']['registered']}; ATE PGO "
          f"{ates128['kernel']['ate_pgo']:.6f} / {ates128['plain']['ate_pgo']:.6f}, final "
          f"{ates128['kernel']['ate']:.6f} / {ates128['plain']['ate']:.6f}; routes {gap128:.3g} "
          f"apart; {k128_ms:.1f} ms (kernels, first call), {p128_ms:.1f} ms (plain), "
          f"{again128_ms:.1f} ms (kernels, again; host clock) "
          f"[{time.perf_counter() - t_phase:.1f} s]", flush=True)

    # (c) The JAX tests' scale points, with their bounds.
    graph, gt = problems.pose_graph_problem(seed=9, M=256, noise=0.02, device=dev)
    pgo = optimize_pose_graph(graph, iters=12)
    ate_opt = problems.ate_rmse(pgo.poses.double().cpu().numpy(), gt)
    ate_init = problems.ate_rmse(graph.poses.double().cpu().numpy(), gt)
    check(float(pgo.final_cost) < float(pgo.initial_cost), "PGO M=256: cost did not fall")
    check(ate_opt < 0.5 * ate_init and ate_opt < 0.2,
          f"PGO M=256: ATE {ate_opt} (odometry {ate_init})")
    prob, gtp, _ = problems.ba_problem(seed=8, M=128, L=4096, G=4, noise=0.005, init_noise=0.03,
                                       device=dev)
    ba = bundle_adjust(prob, iters=6, cg_iters=96)
    ate_ba = problems.ate_rmse(ba.poses.double().cpu().numpy(), gtp)
    check(float(ba.final_cost) < 0.2 * float(ba.initial_cost),
          f"BA M=128: cost {float(ba.initial_cost)} -> {float(ba.final_cost)}")
    check(ate_ba < 0.05, f"BA M=128: ATE {ate_ba}")
    # Each solve timed whole on the host clock; its first Gauss-Newton step
    # profiled (a whole solve is 6,000-61,000 launches, which the profiler
    # takes tens of seconds to read).
    scale = {}
    for key, full, step in (
            ("pgo_256", lambda: optimize_pose_graph(graph, iters=12),
             lambda: optimize_pose_graph(graph, iters=1)),
            ("ba_128", lambda: bundle_adjust(prob, iters=6, cg_iters=96),
             lambda: bundle_adjust(prob, iters=1, cg_iters=96))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full()
        torch.cuda.synchronize()
        scale[key] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                          first_step=profile_call(step, reps=2, batches=1))
        st = scale[key]["first_step"]
        print(f"  {key}: {scale[key]['wall_ms']:.1f} ms a solve (host clock); its first step "
              f"wall {st['wall_ms_per_batch']:.1f} ms, busy "
              f"{st['device_busy_ms_per_batch']:.3f} ms, idle {st['idle_share']:.4f}, "
              f"{st['kernels_per_batch']:g} kernels", flush=True)
    print(f"  scale points: PGO ATE {ate_opt:.5f} (odometry {ate_init:.5f}), BA ATE {ate_ba:.5f}, "
          f"cost {float(ba.initial_cost):.4f} -> {float(ba.final_cost):.4f} "
          f"[{time.perf_counter() - t_phase:.1f} s]", flush=True)

    # (d) The sampler ablation at the recorded points, both routes.
    torch.cuda.synchronize()
    _build.reset_launches()
    sweeps = {}
    for K in abl.ABLATION_BUDGETS:
        params = dataclasses.replace(abl.OBJ_PARAMS, max_hypotheses=K)
        sweeps[K, "kernel"] = abl.run_sampler_ablation(
            params, abl.ABLATION_RATIOS, n_pairs=abl.ABLATION_PAIRS, n_corr=1000, seed=0,
            impl="kernel", device=dev)
    torch.cuda.synchronize()
    abl_launches = _build.launches()
    for K in abl.ABLATION_BUDGETS:
        params = dataclasses.replace(abl.OBJ_PARAMS, max_hypotheses=K)
        sweeps[K, "plain"] = abl.run_sampler_ablation(
            params, abl.ABLATION_RATIOS, n_pairs=abl.ABLATION_PAIRS, n_corr=1000, seed=0,
            impl="plain", device=dev)
    for name in PATH_ROWS:
        check(abl_launches[name] > 0, f"{name} was not launched by the ablation")
    hold_ablation_kernels(dev, rows)
    for r in rows:
        if r["name"] in PATH_ROWS or r["name"] == "anchor_topb_topt":
            r["ablation_launches"] = abl_launches[r["name"]]
    cells = {}
    for K in abl.ABLATION_BUDGETS:
        rk, rp = sweeps[K, "kernel"]["recall"], sweeps[K, "plain"]["recall"]
        for ratio in abl.ABLATION_RATIOS:
            check(rk["saccot"][ratio] >= rk["edge"][ratio] >= rk["random"][ratio],
                  f"ablation K={K} {ratio}: recall {rk}")
            check(rk["saccot"][ratio] == rp["saccot"][ratio],
                  f"ablation K={K} {ratio}: saccot recall differs by route")
            for s in ("edge", "random"):
                check(abs(rk[s][ratio] - rp[s][ratio]) <= 1 / abl.ABLATION_PAIRS + 1e-9,
                      f"ablation K={K} {ratio}: {s} recall {rk[s][ratio]} vs {rp[s][ratio]}")
        for route in ("kernel", "plain"):
            print(f"  ablation ({route} route):\n    " +
                  abl.format_table(sweeps[K, route]).replace("\n", "\n    "), flush=True)
            print(f"    ms a cell: " + ", ".join(
                f"{s} " + "/".join(f"{1e3 * v:.1f}" for v in row.values())
                for s, row in sweeps[K, route]["secs"].items()), flush=True)
        cells[K] = {route: dict(recall=sweeps[K, route]["recall"],
                                ms={s: {str(r): 1e3 * v for r, v in row.items()}
                                    for s, row in sweeps[K, route]["secs"].items()})
                    for route in ("kernel", "plain")}
    print(f"  ablation launches (kernel route, both budgets): {abl_launches} "
          f"[{time.perf_counter() - t_phase:.1f} s]", flush=True)

    # (e) The sharded dry runs on two spawned ranks.
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    ranks = run_ranks(dryrun.dryrun_rank, 2, backend, dev.type, timeout=300)
    for r in ranks:
        for name in ("ba", "pgo"):
            d = r[name]
            check(float(d.final_cost) <= float(d.initial_cost) + 1e-9, f"dryrun {name}: cost rose")
            apart = float(np.abs(d.poses - r[f"{name}_one"].poses).max())
            check(apart < 2e-4, f"dryrun {name}: sharded poses {apart} from one rank")
    print(f"  dry runs on 2 ranks ({backend}): BA cost {float(ranks[0]['ba'].initial_cost):.4f} -> "
          f"{float(ranks[0]['ba'].final_cost):.4f}, PGO {float(ranks[0]['pgo'].initial_cost):.4f}"
          f" -> {float(ranks[0]['pgo'].final_cost):.4f}, sharded = one rank within 2e-4: ok",
          flush=True)
    print(json.dumps({"slam": dict(
        config=dict(ate_pgo=ates["kernel"]["ate_pgo"], ate=ates["kernel"]["ate"],
                    plain_ate=ates["plain"]["ate"], route_gap=gap, first_call_ms=k_ms,
                    plain_first_call_ms=p_ms, wall_ms=prof["wall_ms_per_batch"],
                    device_busy_ms=prof["device_busy_ms_per_batch"],
                    idle_share=prof["idle_share"], kernels=prof["kernels_per_batch"],
                    stage_ms=prof["ranges"], own_kernels_ms=prof["own_kernels_ms_per_batch"],
                    top_kernels=prof["top_kernels"], launches=slam_launches,
                    ba_stats=k.ba_stats),
        scans128=dict(edges=len(seq128["edges"]), ate_pgo=ates128["kernel"]["ate_pgo"],
                      ate=ates128["kernel"]["ate"], plain_ate=ates128["plain"]["ate"],
                      route_gap=gap128, first_call_ms=k128_ms, plain_ms=p128_ms,
                      wall_ms=again128_ms),
        pgo_256=dict(ate=ate_opt, **scale["pgo_256"]),
        ba_128=dict(ate=ate_ba, **scale["ba_128"]),
        ablation=cells, ablation_launches=abl_launches)}), flush=True)
    print(f"phase 12 ok ({time.perf_counter() - t_phase:.1f} s)", flush=True)

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
    from saccot_tpu_torch.scripts import exp_small_kernels as xsmall
    from saccot_tpu_torch.utils.profile import kernel_device_ms, launch_floor_ms

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 ok: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    # The loops of the kernels redesigned for Hopper, as compiled, longest
    # first: score's point-tile loop, then its inner loop over 4 points x 2
    # hypotheses; the fused anchor kernel's row loop over 2 columns with and
    # without a column mask, then its selection rounds; the streamed kernel's
    # chunk loop without and with a column mask (template argument
    # ILb<masked>E), then its rescans and rounds.
    for name in ("score_kernel", "anchor_topb_kernel", "anchor_topb_stream_kernel"):
        for fn, loops in sass_loops(name).items():
            print(f"  sass {fn[fn.index(name):][:48]}: loop bodies {loops[:5]} instructions")
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
            f"anchor_topb_{mode}", anchor_cost[mode],
            device_ms=kernel_device_ms(lambda: ktri.anchor_neighbors(P, Q, anchors, B, tau, sep,
                                                                     **kw)),
            plan=plan_str(ktri.anchor_plan(1000, B)))

    pool = tri_mod.triangle_pool_from_points(P, Q, deg_ref, exact, impl="plain")
    triples = pool.triples
    r9, t3 = ksolve.solve3(P, Q, triples)
    r9_ref, t3_ref = ksolve.solve3_reference(P, Q, triples)
    # Solve bit for bit: the kernel spells every operation as an explicitly
    # rounded one, in the plain version's order.
    err = max((r9 - r9_ref).abs().max().item(), (t3 - t3_ref).abs().max().item())
    check(torch.equal(r9, r9_ref) and torch.equal(t3, t3_ref), f"solve3: r9/t3 differ by {err}")
    row("solve3", "saccot_tpu_torch/csrc/solve3.cu", "saccot_tpu/kernels/solve3.py:73", err,
        time_ms(lambda: ksolve.solve3(P, Q, triples)),
        time_ms(lambda: ksolve.solve3_reference(P, Q, triples)), "solve3",
        solve_cost(128, 1000, triples.shape[1]),
        device_ms=kernel_device_ms(lambda: ksolve.solve3(P, Q, triples)),
        plan=solve_plan_str(128, triples.shape[1]))

    hold_score(r9_ref, t3_ref, P, Q, fast.inlier_tau, "the bench point")
    row("score", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31", 0.0,
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, P, Q, fast.inlier_tau)),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, P, Q,
                                                          fast.inlier_tau)), "score",
        score_cost(128, 1000, r9_ref.shape[2]),
        device_ms=kernel_device_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, P, Q,
                                                                   fast.inlier_tau)))
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
    for name, params in (("fast", fast), ("exact", exact)):
        hold_weighted(P, Q, params, T_gt, (5.0, 0.05), f"the bench point, {name}")
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
        ((PAIR_OPS + 1) * 2 * 50000 * 49999 // 2, 4 * 2 * 50000 * 7),
        device_ms=kernel_device_ms(lambda: kcompat.degrees(PK, QK, PK, QK, kp), reps=5))
    print(f"  compat_degrees two-sided kernel at the same shape: {two_sided_ms:.4f} ms, "
          f"max |tri - two-sided| {(deg - deg_2s).abs().max().item():.3g} "
          f"({degree_plan_str(2, 50000, 50000)})", flush=True)

    # Streamed top-B (row 6): scores within 1e-6 of the plain version (the
    # same predicate, the same operations) and indices equal off ties; ties
    # at the last slot are judged against a top-(B+1). Bit for bit across two
    # calls and for each half of the anchors run alone (another grid of
    # anchor tiles): the key is a total order.
    _, anchors = ktri.topk_stable(deg_ref, A)
    sargs = (PK, QK, anchors, B, tau, sep)
    got = ktri.anchor_neighbors_stream(*sargs)
    ref = ktri.anchor_neighbors_reference(*sargs)
    err_s = (got[0] - ref[0]).abs().max().item()
    check(err_s <= 1e-6, f"anchor_topb_stream: scores differ by {err_s}")
    wider = ktri.anchor_neighbors_reference(PK, QK, anchors, B + 1, tau, sep)[0]
    clear = off_ties(wider, 1e-6)[..., :B]
    check(torch.equal(got[1][clear], ref[1][clear]), "anchor_topb_stream: indices differ")
    again = ktri.anchor_neighbors_stream(*sargs)
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "anchor_topb_stream: two calls differ")
    for lo, hi in ((0, A // 2), (A // 2, A)):
        part = ktri.anchor_neighbors_stream(PK, QK, anchors[:, lo:hi].contiguous(), B, tau, sep)
        check(torch.equal(part[0], got[0][:, lo:hi]) and torch.equal(part[1], got[1][:, lo:hi]),
              f"anchor_topb_stream: anchors {lo}..{hi} run alone differ from the full call")
    # At N=3,000 the streamed kernel is the fused one bit for bit under three
    # plans, with and without masks: one chunk of 3,000 columns a warp, three
    # chunks of 1,024 (the last one ragged) and 429 chunks of 7 columns
    # (fewer than B: each chunk's list ends in empty slots; the last chunk
    # holds 4).
    P3k, Q3k, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device=dev, n=3000)
    deg3 = kcompat.degrees(P3k, Q3k, P3k, Q3k, kp)
    _, anc3 = ktri.topk_stable(deg3, A)
    a3 = (P3k, Q3k, anc3, B, tau, sep)
    fu3 = ktri.anchor_neighbors(*a3, top_t=T)
    m3 = (torch.arange(3000, device=dev) % 7 != 3).float().expand(2, 3000).contiguous()
    mkw = dict(mask=m3, anchor_mask=torch.gather(m3, 1, anc3))
    fu3m = ktri.anchor_neighbors(*a3, **mkw)
    sms, plans3 = kcompat.sm_count(dev), []
    for chunk_n in (3000, 1024, 7):
        plans3.append(plan_str(ktri.stream_plan(2, A, 3000, B, sms, chunk_n=chunk_n)))
        for want, kw in ((fu3, {}), (fu3m, mkw)):
            st3 = ktri.anchor_neighbors_stream(*a3, **kw, chunk_n=chunk_n)
            check(torch.equal(st3[0], want[0]) and torch.equal(st3[1], want[1]),
                  f"anchor_topb_stream (chunk_n={chunk_n}, mask={bool(kw)}) differs from the "
                  "fused kernel at N=3000")
    splan = ktri.stream_plan(2, A, 50000, B, sms)
    print(f"  anchor_topb_stream at kitti: {plan_str(splan)}, {splan.blocks} blocks; within "
          f"{err_s:.3g} of plain, bit-identical across two calls and anchor halves; at N=3000 "
          f"bit-identical to the fused kernel under {plans3}", flush=True)
    row("anchor_topb_stream", "saccot_tpu_torch/csrc/anchor_topb_stream.cu",
        "saccot_tpu/kernels/triangles.py:201", err_s,
        time_ms(lambda: ktri.anchor_neighbors_stream(*sargs), reps=10),
        time_ms(lambda: ktri.anchor_neighbors_reference(*sargs), **big), "anchor_topb_stream",
        ((PAIR_OPS + 1) * 2 * A * 50000, 4 * 2 * 50000 * 6 + 8 * 2 * A + 12 * 2 * A * B),
        device_ms=kernel_device_ms(lambda: ktri.anchor_neighbors_stream(*sargs)),
        plan=f"{plan_str(splan)}, {splan.blocks} blocks")

    # The card's launch floor: an empty kernel, one thread, read as every
    # kernel's device ms is.
    floor = launch_floor_ms()
    print(f"  launch floor: {floor:.4f} ms device (an empty kernel, one thread)", flush=True)

    # Candidate top-T (row 7): scores within 1e-5 of the plain version (sums
    # of three scores), node ids equal off ties. Under every W of the sweep:
    # the same bits at kitti, and for each half of the anchors run alone; at
    # N=3,000 the fused kernel's top-T mode's on its own selections, with and
    # without masks (the same device functions at the same warp scope).
    cargs = (got[0], got[1], PK, QK, T, tau, sep)
    cg = ktri.candidate_topt(*cargs)
    cr = ktri.candidate_topt_reference(*cargs)
    err_c = (cg[0] - cr[0]).abs().max().item()
    check(err_c <= 1e-5, f"candidate_topt: scores differ by {err_c}")
    clear_t = off_ties(cr[0], 1e-6) & (cr[0] > 0)
    check(bool(clear_t.any()) and torch.equal(cg[1][clear_t], cr[1][clear_t])
          and torch.equal(cg[2][clear_t], cr[2][clear_t]), "candidate_topt: node ids differ")
    fu3mt = ktri.anchor_neighbors(*a3, **mkw, top_t=T)
    for plan in xsmall.candidate_plans(2, A, B):
        check(all(torch.equal(x, y) for x, y in zip(ktri._candidate(*cargs, plan), cg)),
              f"candidate_topt ({plan_str(plan)}) differs from candidate_plan's bits at kitti")
        for lo, hi in ((0, A // 2), (A // 2, A)):
            half = ktri._candidate(got[0][:, lo:hi].contiguous(), got[1][:, lo:hi].contiguous(),
                                   *cargs[2:], ktri.make_candidate_plan(2, hi - lo, B, plan.warps))
            check(all(torch.equal(x, y[:, lo:hi]) for x, y in zip(half, cg)),
                  f"candidate_topt (warps={plan.warps}): anchors {lo}..{hi} run alone differ")
        for want in (fu3, fu3mt):
            c3 = ktri._candidate(want[0], want[1], P3k, Q3k, T, tau, sep, plan)
            check(all(torch.equal(x, y) for x, y in zip(c3, want[2:])),
                  f"candidate_topt (warps={plan.warps}, mask={want is fu3mt}) differs from the "
                  "fused kernel's top-T mode at N=3000")
    cplan = ktri.candidate_plan(2, A, B)
    print(f"  candidate_topt at kitti: {plan_str(cplan)}, {cplan.blocks} blocks; within "
          f"{err_c:.3g} of plain; under warps {[p.warps for p in xsmall.candidate_plans(2, A, B)]}"
          " the same bits, for each half of the anchors alone, and at N=3000 the fused top-T "
          "mode's with and without masks", flush=True)
    row("candidate_topt", "saccot_tpu_torch/csrc/candidate_topt.cu",
        "saccot_tpu/kernels/triangles.py:378", err_c,
        time_ms(lambda: ktri.candidate_topt(*cargs)),
        time_ms(lambda: ktri.candidate_topt_reference(*cargs)), "candidate_topt",
        ((PAIR_OPS + 4) * 2 * A * B * (B - 1) // 2, 2 * A * B * 36 + 20 * 2 * A * T),
        device_ms=kernel_device_ms(lambda: ktri.candidate_topt(*cargs)),
        plan=f"{plan_str(cplan)}, {cplan.blocks} blocks")

    # Solve and score at N=50,000 (the TPU streamed the solve above its VMEM
    # cap; the direct-index kernels take any N), score's tolerances as in
    # phase 3. The solve (row 8) bit for bit under every block size of the
    # sweep, here and at the bench point.
    kpool = tri_mod.triangle_pool_from_points(PK, QK, deg_ref, kp, impl="plain")
    ktrip = kpool.triples
    r9, t3 = ksolve.solve3(PK, QK, ktrip)
    r9_ref, t3_ref = ksolve.solve3_reference(PK, QK, ktrip)
    err = max((r9 - r9_ref).abs().max().item(), (t3 - t3_ref).abs().max().item())
    check(torch.equal(r9, r9_ref) and torch.equal(t3, t3_ref),
          f"solve3 at N=50000: r9/t3 differ by {err}")
    for Ps, Qs, trip, where in ((PK, QK, ktrip, "kitti"), (P, Q, triples, "the bench point")):
        want = ksolve.solve3_reference(Ps, Qs, trip)
        for plan in xsmall.solve_plans(*trip.shape[:2]):
            check(all(torch.equal(x, y) for x, y in zip(ksolve._solve(Ps, Qs, trip, plan), want)),
                  f"solve3 ({plan_str(plan)}) at {where} differs from solve3_reference")
    print(f"  solve3: bit-identical to solve3_reference in blocks of "
          f"{list(xsmall.SOLVE_THREADS)} threads at kitti and the bench point", flush=True)
    row("solve3_large_n", "saccot_tpu_torch/csrc/solve3.cu",
        "saccot_tpu/kernels/solve3.py:124", err,
        time_ms(lambda: ksolve.solve3(PK, QK, ktrip)),
        time_ms(lambda: ksolve.solve3_reference(PK, QK, ktrip)), "solve3",
        solve_cost(2, 50000, ktrip.shape[1]),
        device_ms=kernel_device_ms(lambda: ksolve.solve3(PK, QK, ktrip)),
        plan=solve_plan_str(2, ktrip.shape[1]))
    kargs = (r9_ref, t3_ref, PK, QK, kp.inlier_tau)
    hold_score(*kargs, "kitti")
    row("score_large_n", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31", 0.0,
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, PK, QK, kp.inlier_tau),
                reps=10),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, PK, QK,
                                                          kp.inlier_tau), **big), "score",
        score_cost(2, 50000, r9_ref.shape[2]),
        device_ms=kernel_device_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, PK, QK,
                                                                   kp.inlier_tau)))
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
    for name, params in (("exact", kp), ("fast", kfast)):
        hold_weighted(PK, QK, params, TK, KITTI_CRITERION, f"kitti, {name}")
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

    # -- phase 11: the cloud pipeline at the bunny configuration -----------
    phase11(dev, rows)

    # -- phase 12: sequence SLAM and the sampler ablation ------------------
    phase12(dev, rows)

    for r in rows:
        r["device_over_floor"] = r["device_ms"] / floor
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
