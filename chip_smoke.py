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
     against its plain version, with its `solve_plan`, and under every
     block size of its sweep (`hold_solve_plans`: blocks of 32-256); the
     refine kernel (row 12) against its plain version from the best
     hypothesis, with and without a mask (`hold_refine`: R, t within 1e-5,
     its inlier mask its own fit's bit for bit, flips from the plain mask
     only within the two fits' reach of tau, the same bits in two calls and
     for the last pair alone);
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
     hypotheses a pair), held as in phase 3, and the solve under every
     block size; the pool's ranking kernel (row 13) on the fused kernel's
     candidates, with and without dedup, bit for bit its plain version,
     its duplicate count the plain mask's sum, there and tiled to the
     1,623 pairs of a threedmatch.sweep call, where it is timed;
  6. the large-N kernels against their plain versions at the kitti shapes
     (batch 2, N=50,000, A=512, B=16, T=4, K=2048): the symmetric degree
     kernel (also bit-identical across two calls, and against the two-sided
     kernel; masked as the padded cells send it, at N=50,000 and 2,500 with
     one pair of no valid entry: masked rows 0, two calls bit for bit, and
     its count of skipped tile pairs), the streamed top-B (also
     bit-identical across two calls and for each half of the anchors run
     alone, and to the fused kernel at N=3,000 under three plans, with and
     without masks: one chunk, chunks of 1,024, and chunks of 7 columns,
     fewer than B); the pool's ranking kernel held as in phase 5 on the
     streamed selections' candidates, there and tiled to the 64 pairs of a
     kitti.sweep call; the card's launch floor
     (an empty kernel, one thread); the candidate top-T under every W of
     its sweep (the same bits, also for each half of the anchors alone, and
     at N=3,000 the fused kernel's top-T mode's, with and without masks);
     the solve bit for bit under every block size of its sweep at kitti
     (phases 3 and 5 at the bench and 3DMatch points), the score kernel
     at N=50,000, held as in phase 3 there and at the SP shard's 25,000
     points, and the refine kernel at N=50,000, held as in phase 3;
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
     each held to the single-rank runs of phases 4, 5 and 7; the per-pair
     forms `register_pair_tp` and `register_pair_sp` on one pair of the TP
     and the 3DMatch SP batch, every field bit for bit the batch forms'
     rows (the refine kernel's sums are fixed by the shard's N alone); SP's
     refine fits after its all-reduces (`refine_fit`, once a fit); which
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
     by PCG): the same edges registered, PGO poses and the final poses BA
     observes 10+ times within 1e-3, the 13 observed fewer times (set by
     rounding: BA's known limit) held by each route's ATE; the JAX tests'
     scale points (PGO by PCG at M=256, BA at M=128, L=4,096) within their
     bounds; the sampler ablation at the recorded points (16 pairs, N=1,000,
     K = 128 and 512, 80/90/95% outliers) by both routes: recall saccot >=
     edge >= random on the kernel route, saccot equal by route, edge and
     random within 1/16, rows 1-4's launches counted; the sharded BA and PGO
     dry runs on two spawned ranks, each within 2e-4 of one rank; one
     {"slam": {...}} line of the readings;
 13. the command line (`python -m saccot_tpu_torch.cli.main`), its `main`
     run in this process once per mode, each JSON line checked, each run's
     launches counted alone and its wall time printed with the card's name
     and power limit: the five run configurations at their own sizes (bunny
     recall 1.0; u3m 45 pairs, at least 33 eligible pairs registered;
     threedmatch in shards of 16, T bit for bit phase 5's; kitti through
     `register_pair`, every stage (the refine kernel's sums are fixed by N
     alone) and T bit for bit phase 7's batch of 2; slam 13 of 13 edges, ATE equal to
     phase 12's), files (two PLY views of 8,192 points), sequence --loops
     (8 KITTI scans of 30,000 points on a closed circle: a loop closure,
     the optimised ATE at most 1.2 x the raw one), external (8 fragments of
     5,000 keypoints, recall 1.0, --out-log read back), ablate (16 pairs:
     saccot >= edge >= random), the threedmatch sweep killed after shard 0
     in a child process (exit 17) and resumed to the uninterrupted run's
     recall and bits, `measure_scaling` at size 1; rows 1-4 held to their
     plain versions on the u3m and external inputs; one {"cli": {...}}
     line of the metrics;
 14. the last four modules at the bench point: (a) the NumPy oracle
     (`saccot_tpu_torch.oracle`) on 4 pairs (seeds 1000-1003, exact
     configuration) on the host against `register_batch` on the card: the
     same recall, T within 1e-3 deg and 1e-4, inliers within 1, the
     oracle's pairs/s labelled with the host CPU; (b) one fast batch of
     128 stage by stage (degrees, pool, solve, score, refine) under
     `utils.profiling.StageTimer`, bit for bit `register_batch`, each
     stage's `roofline_fraction`; (c) `utils.profiling.trace` around one
     fast and one exact batch: the Chrome trace's device events name rows
     1-4's `__global__` functions as often as their launch counters moved,
     and every launch call of the batches has its kernel event;
     (d) `utils.debug.nan_guard`: a clean fast batch has the unguarded
     bits, and a NaN point named by the pool's triples raises
     FloatingPointError naming the solve on the kernel and the plain
     route; one {"phase14": {...}} line of the readings;
 15. the per-stage routes: `register_batch` at the bench point, fast and
     exact, once for each single-stage mix (one of compat_impl, pool_impl,
     solve_impl and score_impl "plain", the rest "kernel"): recall >= 0.98,
     the plain stage launching no kernel and the others theirs, each stage
     held to the version the mix names on the mix's own inputs (the exact
     pool's ranking kernel launched once a call, none with the plain pool),
     and the solve_impl="plain" mix bit for bit the all-kernel T of phase 4;
     B = 40 refused by the pool's kernel and run by the plain pool.
Each kernel row carries its bound: the larger of its FP32 operations over
the card's FP32 instruction rate and its bytes over the memory rate
(`bound_ms` of the row's model in `saccot_tpu_torch.evaluation.roofline`),
and its device ms over the launch floor (`device_over_floor`). The line
before the last is a
JSON table of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time


# Every kernel bound (the card's FP32 instruction and memory rates, one
# model of each kernel row's work from its shapes) is defined once, in
# evaluation/roofline; the CUDA-event timer beside the per-operation
# attribution that measures the degree loop.
from saccot_tpu_torch.evaluation import roofline
from saccot_tpu_torch.scripts.exp_compat_ops import sass_loops, time_ms


class PhaseError(RuntimeError):
    pass


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


def hold_solve_plans(P, Q, triples, where):
    """The solve under every block size of its sweep (`exp_small_kernels.
    solve_plans`) bit for bit against `solve3_reference`. Returns the block
    sizes."""
    import torch

    from saccot_tpu_torch.kernels import solve3 as ksolve
    from saccot_tpu_torch.scripts import exp_small_kernels as xsmall

    want = ksolve.solve3_reference(P, Q, triples)
    plans = xsmall.solve_plans(*triples.shape[:2])
    for plan in plans:
        check(all(torch.equal(x, y) for x, y in zip(ksolve._solve(P, Q, triples, plan), want)),
              f"solve3 ({plan_str(plan)}) at {where} differs from solve3_reference")
    return [plan.threads for plan in plans]


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


def hold_refine(P, Q, scores, valid, r9, t3, params, where):
    """The refine kernel (row 12) against its plain version from the best
    hypothesis of `scores`, with no mask and with one that drops every
    fifth point: R and t within 1e-5 (the same sums in another order), the
    kernel's inlier mask `inlier_mask` of its own fit bit for bit, and where
    it differs from the plain refine's, the point's residual under the
    plain fit within the two fits' distance at that point of tau; the same
    bits in two calls and for the last pair refined alone. Returns the
    largest R, t difference and the best hypothesis (R, t)."""
    import torch

    from saccot_tpu_torch.engine import score as score_mod
    from saccot_tpu_torch.engine.sac_cot import best_hypothesis
    from saccot_tpu_torch.kernels import refine as krefine

    _, R, t = best_hypothesis(scores, valid, r9, t3)
    tau = params.inlier_tau
    err, flips = 0.0, 0
    for masked in (False, True):
        m = torch.ones(P.shape[:2], device=P.device)
        if masked:
            m[:, ::5] = 0.0
        (Rk, tk, ik), (Rp, tp, ip) = (krefine.refine(P, Q, R, t, params, m),
                                      krefine.refine_reference(P, Q, R, t, params, m))
        err = max(err, (Rk - Rp).abs().max().item(), (tk - tp).abs().max().item())
        check(err <= 1e-5, f"refine at {where}: R, t {err} from the plain refine")
        check(torch.equal(ik, score_mod.inlier_mask(Rk, tk, P, Q, tau, mask=m)),
              f"refine at {where}: the mask is not its own fit's")
        flip = ik != ip
        if flip.any():
            x = score_mod._residual(Rp, tp, P, Q)
            d = torch.sqrt((x * x).sum(-1))
            reach = ((Rk - Rp).flatten(1).norm(dim=1)[:, None] * P.norm(dim=-1)
                     + (tk - tp).norm(dim=1)[:, None] + 1e-6 * tau)
            check(bool(((d - tau).abs() <= reach)[flip].all()),
                  f"refine at {where}: an inlier flip beyond the fits' reach of tau")
        flips += int(flip.sum())
        again = krefine.refine(P, Q, R, t, params, m)
        last = krefine.refine(P[-1:], Q[-1:], R[-1:], t[-1:], params, m[-1:])
        check(all(torch.equal(a, b) for a, b in zip(again, (Rk, tk, ik)))
              and all(torch.equal(a[0], b[-1]) for a, b in zip(last, (Rk, tk, ik))),
              f"refine at {where}: another call or the last pair alone gives other bits")
    print(f"  refine at {where}: {krefine.refine_plan(P.shape[0], P.shape[1], params.refine_iters)}"
          f"; R, t within {err:.3g} of the plain refine, {flips} inlier flips, bit for bit "
          f"across two calls and for the last pair alone", flush=True)
    return err, R, t


def hold_pool_rank(anchors, nbr_s, nbr_idx, cand, params, n_nodes, where):
    """The pool's ranking kernel (row 13) against its plain version on the
    same candidates, with and without dedup: triples, scores and valid bit
    for bit, one launch a call, two calls the same bits; the duplicate
    count the plain mask's sum a pair. Returns the kernel's plan."""
    import torch

    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.kernels import triangles as ktri

    args = (anchors, nbr_s, nbr_idx, cand, params.max_hypotheses)
    for dedup in (True, False):
        before = _build.launches()["pool_rank"]
        got = ktri.pool_rank(*args, dedup, n_nodes)
        check(_build.launches()["pool_rank"] == before + 1,
              f"pool_rank at {where}: not one launch a call")
        check(all(torch.equal(x, y) for x, y in
                  zip(got, ktri.pool_rank_reference(*args, dedup, n_nodes))),
              f"pool_rank at {where} (dedup={dedup}) differs from its plain version")
        check(all(torch.equal(x, y) for x, y in zip(got, ktri.pool_rank(*args, dedup, n_nodes))),
              f"pool_rank at {where} (dedup={dedup}): two calls differ")
    b1, b2 = ktri.pair_slots(nbr_idx.shape[2], nbr_idx.device)
    dup = ktri.mark_cross_anchor_duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2,
                                            n_nodes).sum(dim=(1, 2))
    check(torch.equal(ktri.DUPLICATES_MARKED[-1], dup),
          f"pool_rank at {where}: the duplicate count is not the plain mask's sum")
    plan = ktri.pool_rank_plan(anchors.shape[1], nbr_idx.shape[2], params.max_hypotheses)
    valid = got[2].sum(dim=1)
    print(f"  pool_rank at {where}: {plan}; bit for bit the plain version with and without "
          f"dedup, two calls alike; duplicates a pair {int(dup.min())}..{int(dup.max())}, "
          f"valid entries {int(valid.min())}..{int(valid.max())} of {params.max_hypotheses}",
          flush=True)
    return plan


def tiled(x, batch):
    """x [b, ...] repeated along its first axis to `batch` rows."""
    return x.repeat((-(-batch // x.shape[0]),) + (1,) * (x.dim() - 1))[:batch].contiguous()


def hold_tri_skips(P, Q, params, keep, where):
    """The symmetric degree kernel under masks padded at the end, pair b
    keeping its first keep[b] points (0: no valid entry), where its blocks
    skip every tile pair past the pair's last valid tile: within rtol 1e-5
    / atol 2e-3 of the plain version, 0 at every masked row, the same bits
    in two calls, and the tile pairs it counts in `TILE_PAIRS_SKIPPED`
    T (T + 1) / 2 - k (k + 1) / 2 a pair, of T tiles of 128 with k of them
    holding a valid entry."""
    import torch

    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.kernels import compat as kcompat

    n = P.shape[1]
    mask = (torch.arange(n, device=P.device)[None]
            < torch.tensor(keep, device=P.device)[:, None]).float()
    kcompat.TILE_PAIRS_SKIPPED.clear()
    _build.reset_launches()
    deg = kcompat.degrees(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    again = kcompat.degrees(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    check(_build.launches()["compat_degrees_tri"] == 2,
          f"masked degrees at {where} did not take the tri route")
    ref = kcompat.degrees_reference(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    torch.testing.assert_close(deg, ref, rtol=1e-5, atol=2e-3)
    check(not deg[mask == 0].any(), f"compat_degrees_tri at {where}: a masked row is not 0")
    check(torch.equal(deg, again), f"compat_degrees_tri at {where}: two masked calls differ")
    tiles = -(-n // 128)
    want = [tiles * (tiles + 1) // 2 - k * (k + 1) // 2 for k in (-(-m // 128) for m in keep)]
    got = [c.tolist() for c in kcompat.TILE_PAIRS_SKIPPED]
    check(got == [want, want], f"compat_degrees_tri at {where}: skipped {got}, not {want}")
    print(f"  compat_degrees_tri masked at {where} (N={n}, keeping {list(keep)}): max |err| "
          f"{(deg - ref).abs().max().item():.3g}, masked rows 0, bit for bit across two calls, "
          f"skipped {want} of {tiles * (tiles + 1) // 2} tile pairs a pair", flush=True)


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


# BA poses that the landmark tracks observe fewer times than this are held
# by ATE, not pose by pose (tests/test_torch_slam_sequence.py WELL_OBSERVED).
WELL_OBSERVED = 10


def hold_slam_routes(k, p, seq, what, same_stats=True):
    """Both routes of one sequence: every edge registered the same way, the
    same BA track stats, PGO poses and the final poses that BA's tracks
    observe at least WELL_OBSERVED times (or not at all) within 1e-3, each
    route's final ATE under the slam bound; returns the ATEs (PGO and final)
    of each route and the largest final-pose gap (all poses; the weakly
    observed ones are set by rounding, as the known limit of BA says: their
    reduced system is damped to condition about 1e10, so the routes' edges,
    which the refine kernel and the plain refine sum in other orders, move
    them apart)."""
    import torch

    from saccot_tpu_torch.evaluation.metrics import ate
    from saccot_tpu_torch.slam import frontend as fe

    E = len(seq["edges"])
    check(torch.equal(k.registration.success, p.registration.success),
          f"{what}: the routes register different edges")
    if same_stats:
        for key in k.ba_stats:
            same = (abs(k.ba_stats[key] - p.ba_stats[key]) <= 1e-6 * abs(p.ba_stats[key])
                    if key == "huber_delta" else k.ba_stats[key] == p.ba_stats[key])
            check(same, f"{what}: BA track stat {key} {k.ba_stats[key]} vs {p.ba_stats[key]}")
    pgo_gap = (k.pose_graph_result.poses - p.pose_graph_result.poses).abs().max().item()
    check(pgo_gap < 1e-3, f"{what}: PGO poses of the routes {pgo_gap} apart")
    prob, _ = fe.correspondences_to_ba(
        k.pose_graph_result.poses, seq["edges"], seq["edge_P"], seq["edge_Q"],
        k.registration.inliers.cpu().numpy(), merge_cell=3.0 * fe.SLAM_PARAMS.inlier_tau,
        device=k.poses.device)
    real = prob.obs_w > 0
    obs = torch.bincount(prob.obs_pose[real].long(), minlength=k.poses.shape[0])
    firm = (obs == 0) | (obs >= WELL_OBSERVED)
    gaps = (k.poses - p.poses).abs().flatten(1).max(dim=1).values
    gap, firm_gap = gaps.max().item(), gaps[firm].max().item()
    check(firm_gap < 1e-3, f"{what}: final poses of the routes {firm_gap} apart")
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
        check(out[name]["ate"] < fe.SLAM_ATE_BOUND, f"{what}: final ATE {out[name]['ate']} "
                                                    f"({name})")
    print(f"  {what}: PGO poses {pgo_gap:.3g} apart; final poses {firm_gap:.3g} apart where "
          f"BA observes them {WELL_OBSERVED}+ times, {gap:.3g} on the "
          f"{int((~firm).sum())} observed fewer times", flush=True)
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
    their rows. Returns the kernel route's final ATE at the slam
    configuration."""
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
    check(gap < 1e-3, f"slam: final poses of the routes {gap} apart")  # every pose, here
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
    return ates["kernel"]["ate"]

# -- phase 13: the command line ------------------------------------------------

def write_ply(path, pts):
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n")
    path.write_bytes(header.encode() + pts.astype("<f4").tobytes())


def write_files_pair(root):
    """Two PLY views of `two_view_pair(seed=41, n_points=8192, overlap=0.85,
    noise=0.002)` and their 4x4 ground truth as text: the files mode's
    arguments."""
    import numpy as np

    from saccot_tpu_torch.io.synthetic import two_view_pair

    pair = two_view_pair(seed=41, n_points=8192, overlap=0.85, noise=0.002)
    write_ply(root / "src.ply", pair["source"])
    write_ply(root / "tgt.ply", pair["target"])
    np.savetxt(root / "gt.txt", pair["T_gt"])
    return ["--src", str(root / "src.ply"), "--tgt", str(root / "tgt.ply"),
            "--gt", str(root / "gt.txt")]


def write_sequence_scans(root, n_scans=8, n_points=30000, seed=23):
    """KITTI .bin scans of one scene-scale surface (a deformed sphere of
    radius ~5 m, `n_points` points a scan, 5 mm noise) seen from `n_scans`
    poses on a closed circle of radius 0.6 m (the last position is the
    first), and their poses.txt: the sequence mode's arguments at its
    defaults (0.25 m scale, 65,536-point buckets)."""
    import numpy as np

    from saccot_tpu_torch.io.synthetic import blob_cloud
    from saccot_tpu_torch.utils import se3np

    rng = np.random.default_rng(seed)
    world = blob_cloud(rng, n_points, order=8, deform=0.6) * 5.0
    poses = []
    for a in np.linspace(0, 2 * np.pi, n_scans):
        T = np.eye(4)
        T[:3, :3] = se3np.exp_so3(np.array([0.0, 0.0, a * 0.05]))
        T[0, 3] = np.cos(a) * 0.6 - 0.6
        T[1, 3] = np.sin(a) * 0.6
        poses.append(T)
    for i, pose in enumerate(poses):
        scan = se3np.apply_T(np.linalg.inv(pose), world)
        scan = scan + rng.normal(scale=0.005, size=scan.shape)
        raw = np.concatenate([scan, np.zeros((len(scan), 1))], axis=1)
        raw.astype("<f4").tofile(root / f"{i:06d}.bin")
    np.savetxt(root / "poses.txt", np.stack([p[:3, :].reshape(-1) for p in poses]))
    return ["--dir", str(root), "--poses", str(root / "poses.txt")]


def write_external_scene(root, n_frag=8, n_world=8000, n_keep=5000, dim=32, seed=5):
    """tests/test_cli_external.py's scene at 8 fragments of 5,000 keypoints:
    world points with persistent random 32-D descriptors, each fragment a
    posed noisy subset, gt.log the exact relative poses (consecutive pairs
    and (0, 7)) in the Redwood/3DMatch convention. The external mode's
    arguments."""
    import numpy as np

    from saccot_tpu_torch.io.external import save_descriptors_npz
    from saccot_tpu_torch.utils import se3np

    rng = np.random.default_rng(seed)
    W = rng.uniform(-1.5, 1.5, size=(n_world, 3)).astype(np.float32)
    D = rng.normal(size=(n_world, dim)).astype(np.float32)
    frag_dir = root / "fragments"
    frag_dir.mkdir()
    poses = []
    for k in range(n_frag):
        T = se3np.random_transform(rng, max_angle_rad=0.8, max_trans=0.5)
        poses.append(T)
        idx = np.sort(rng.choice(n_world, size=n_keep, replace=False))
        x = se3np.apply_T(se3np.inv_T(T), W[idx]).astype(np.float32)
        x += rng.normal(scale=0.003, size=x.shape).astype(np.float32)
        d = (D[idx] + rng.normal(scale=0.05, size=(n_keep, dim))).astype(np.float32)
        save_descriptors_npz(str(frag_dir / f"cloud_bin_{k}.npz"), x, d)
    pairs = [(i, i + 1) for i in range(n_frag - 1)] + [(0, n_frag - 1)]
    with open(root / "gt.log", "w") as f:
        for (i, j) in pairs:
            T_ij = se3np.inv_T(poses[i]) @ poses[j]
            f.write(f"{i} {j} {n_frag}\n")
            for r in range(4):
                f.write(" ".join(f"{v:.9f}" for v in T_ij[r]) + "\n")
    return ["--dir", str(frag_dir), "--gt-log", str(root / "gt.log")]


class Recorded:
    """Wrap `module.name` while the block runs; keep(args, kwargs, result)
    of every call in `calls`."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep, self.calls = module, name, keep, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def rec(*a, **k):
            out = self.orig(*a, **k)
            self.calls.append(self.keep(a, k, out))
            return out

        setattr(self.module, self.name, rec)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def batch_stages(P, Q, params):
    """`register_batch` on the batch and on each pair alone, each stage's
    outputs recorded (degrees, pool, solve, scores, the refine's R, t and
    inlier mask): for every stage, whether each pair's slice has the same
    bits alone as in the batch."""
    import torch

    from saccot_tpu_torch import register_batch
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import compat, score, solve3
    from saccot_tpu_torch.kernels import refine as krefine

    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in flat(y)]

    keep = lambda a, k, out: flat(out)
    stages = ((compat, "degrees"), (tri_mod, "triangle_pool_from_points"),
              (solve3, "solve3"), (score, "score_hypotheses"), (krefine, "refine"))
    same = {}
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(Recorded(mod, name, keep)) for mod, name in stages}
        register_batch(P, Q, params)
        whole = {name: list(c) for name, c in calls.items()}
        for b in range(P.shape[0]):
            for c in calls.values():
                c.clear()
            register_batch(P[b:b + 1], Q[b:b + 1], params)
            for name, c in calls.items():
                for got, want in zip(c, whole[name]):
                    for x, y in zip(got, want):
                        same[name] = same.get(name, True) and torch.equal(x[0], y[b])
    return same


# The kernels each command-line run must launch: rows 1-4 (the estimator at
# N <= 2048, row 2 in its candidates mode), at kitti rows 5, 6, 8 and 4.
KITTI_ROWS = ("compat_degrees_tri", "anchor_topb_stream", "solve3", "score")


def phase13(dev, rows, ref, card):
    """The command line: the port's `main` in this process, once per mode,
    each JSON line parsed and checked. The five run configurations at their
    own sizes (bunny 4 pairs x 8,192 points; u3m 10 views, 45 pairs;
    threedmatch 32 pairs x 2,048 in shards of 16, T bit for bit phase 5's;
    kitti 2 pairs x 50,000, each stage and T bit for bit phase 7's
    (`batch_stages`); slam 10 scans, 13
    edges, ATE equal to phase 12's); files (two PLY views of 8,192 points
    with --gt), sequence --loops (8 KITTI scans of 30,000 points on a closed
    circle), external (8 fragments of 5,000 keypoints, --out-log read
    back), ablate --pairs 16; the threedmatch sweep killed after shard 0 in
    a child process (exit 17) and resumed here; `measure_scaling` at size 1.
    Rows 1-4 held to their plain versions on the u3m and the external
    inputs (`cli_max_abs_err`). Each run counted on its own
    (`cli_launches` on the rows); its wall time printed with the card."""
    import io
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from saccot_tpu_torch.cli import external, runners
    from saccot_tpu_torch.cli.configs import CONFIGS
    from saccot_tpu_torch.cli.main import main as cli_main
    from saccot_tpu_torch.evaluation.scaling import measure_scaling
    from saccot_tpu_torch.features import pipeline as fp
    from saccot_tpu_torch.io.loaders import load_gt_log
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.utils.checkpoint import SweepCheckpointer

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    scratch = root / "build" / "chip_smoke_cli"
    scratch.mkdir(parents=True, exist_ok=True)
    launches, out = {}, {}

    def run(key, args, expect=PATH_ROWS):
        """One `main` call, counted alone; its JSON line."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[key] = _build.launches()
        check(rc == 0, f"cli {key}: exit code {rc}")
        for name in expect:
            check(launches[key][name] > 0, f"cli {key}: {name} was not launched")
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[key] = dict(m, command_s=wall)
        times = {k: m[k] for k in ("mean_wall_s", "pairs_per_sec", "wall_s", "total_wall_s")
                 if m.get(k) is not None}
        print(f"  cli {key}: {times}, {wall:.3f} s the command ({card})", flush=True)
        return m

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        m = run("bunny", ["bunny"])
        check(m["pairs"] == 4 and m["recall"] == 1.0, f"cli bunny: {m}")

        keep_sets = lambda a, k, res: tuple(x for x in (
            fp.pr_units(res.corr_P[None], res.resolution[None])[0],
            fp.pr_units(res.corr_Q[None], res.resolution[None])[0], res.corr_mask))
        with Recorded(runners, "register_scan_features", keep_sets) as u3m_sets:
            m = run("u3m", ["u3m"])
        hits = round(m["recall"] * m["eligible_pairs"])
        print(f"  cli u3m: {m['views']} views, {m['pairs']} pairs; {hits} of the "
              f"{m['eligible_pairs']} pairs with overlap >= {m['overlap_threshold']} registered "
              f"(recall {m['recall']:.4f}), all pairs {m['recall_all_pairs']:.4f}; by overlap "
              f"band {m['recall_by_overlap_band']} of {m['pairs_by_overlap_band']} pairs",
              flush=True)
        check(m["pairs"] == 45 and hits >= 33, f"cli u3m: {hits} eligible pairs registered")
        P, Q, M = (torch.stack(x) for x in zip(*u3m_sets))
        hold_path_kernels(P, Q, fp.estimator_params(CONFIGS["u3m"].pipeline),
                          "the u3m sweep's 45 pairs", "cli", rows, mask=M)

        ck = tmp / "whole"
        m = run("threedmatch", ["threedmatch", "--ckpt", str(ck)])
        T_tdm = SweepCheckpointer(str(ck)).merged()["T"][:32].astype(np.float32)
        same = np.array_equal(T_tdm, ref["threedmatch_T"])
        print(f"  cli threedmatch: recall {m['recall']:.4f} (phase 5 {ref['threedmatch_recall']:.4f}); "
              f"T of the 32 pairs in shards of 16 bit for bit phase 5's batch of 32: {same}",
              flush=True)
        check(same, "cli threedmatch: T differs from phase 5's")
        check(m["recall"] == ref["threedmatch_recall"], f"cli threedmatch: recall {m['recall']}")

        with Recorded(runners, "registration_error", lambda a, k, r: np.asarray(a[0])) as kT:
            m = run("kitti", ["kitti"], expect=KITTI_ROWS)
        T_gap = float(np.abs(np.stack(kT).astype(np.float32) - ref["kitti_T"]).max())
        # register_pair (a batch of one) against phase 7's batch of two: every
        # kernel, the pool and the refine (its sums fixed by N alone) give the
        # same bits, so T is phase 7's bit for bit.
        same = batch_stages(ref["kitti_P"], ref["kitti_Q"], ref["kitti_params"])
        print(f"  cli kitti: recall {m['recall']:.4f}, {m['n_corr']} correspondences a pair; "
              f"register_pair's T within {T_gap:.3g} of phase 7's batch of 2; alone vs in the "
              f"batch, same bits: {same}", flush=True)
        check(m["pairs"] == 2 and m["recall"] == 1.0, f"cli kitti: {m}")
        check(all(same.values()) and len(same) == 5,
              f"cli kitti: a stage depends on the batch: {same}")
        check(T_gap == 0.0, f"cli kitti: T {T_gap} from phase 7's")

        m = run("slam", ["slam"])
        print(f"  cli slam: {m['edges_registered']} of {m['edges']} edges registered, ATE "
              f"{m['ate_rmse']!r} (phase 12 {ref['slam_ate']!r}), after PGO "
              f"{m['ate_rmse_pgo']!r}", flush=True)
        check(m["edges"] == 13 and m["edges_registered"] == 13, f"cli slam: {m}")
        check(m["ate_rmse"] == ref["slam_ate"], "cli slam: ATE differs from phase 12's")

        m = run("files", ["files"] + write_files_pair(tmp))
        check(m["success"] and m["rot_err_deg"] < 5.0, f"cli files: {m}")
        print(f"  cli files: bucket {m['bucket']}, {m['num_correspondences']} correspondences, "
              f"{m['num_inliers']} inliers, rotation error {m['rot_err_deg']:.4f} deg, "
              f"translation error {m['trans_err']:.5f}", flush=True)

        seq_dir = tmp / "scans"
        seq_dir.mkdir()
        m = run("sequence --loops", ["sequence", "--loops"] + write_sequence_scans(seq_dir))
        print(f"  cli sequence: {m['scans']} scans, native prefetch {m['native_prefetch']}, "
              f"mean inliers {m['mean_inliers']:.1f}, {m['loop_closures']} of "
              f"{m['loop_candidates']} loop candidates confirmed, ATE {m['ate_rmse']:.6f} -> "
              f"{m['ate_rmse_optimized']:.6f} optimized", flush=True)
        check(m["scans"] == 8 and m["pairs"] == 7, f"cli sequence: {m}")
        check(m["loop_closures"] >= 1, f"cli sequence: no loop closure ({m})")
        check(m["ate_rmse_optimized"] <= m["ate_rmse"] * 1.2 + 1e-4, f"cli sequence: {m}")

        ext_args = write_external_scene(tmp)
        keep_batch = lambda a, k, res: (a[0], a[1], k["mask"], a[2])
        est = tmp / "est.log"
        with Recorded(external, "register_batch", keep_batch) as ext_sets:
            m = run("external", ["external", "--out-log", str(est)] + ext_args)
        back, gt = load_gt_log(str(est)), load_gt_log(ext_args[-1])
        print(f"  cli external: {m['n_pairs']} pairs of {m['n_fragments']} fragments, bucket "
              f"{m['bucket']}, recall {m['recall']:.4f}, mean inliers {m['mean_inliers']:.1f}, "
              f"first batch {m['compile_s']:.3f} s; --out-log read back: {len(back)} pairs",
              flush=True)
        check(m["recall"] == 1.0 and m["n_pairs"] == 8, f"cli external: {m}")
        check(set(back) == set(gt), "cli external: --out-log lists other pairs than gt.log")
        P, Q, M, params = ext_sets[-1]
        hold_path_kernels(P, Q, params, "the external mode's 8 pairs", "cli", rows, mask=M)

        m = run("ablate", ["ablate", "--pairs", "16"])
        for ratio in ("0.8", "0.9", "0.95"):
            r = {s: m["recall"][s][ratio] for s in ("saccot", "edge", "random")}
            check(r["saccot"] >= r["edge"] >= r["random"], f"cli ablate {ratio}: {r}")
        print(f"  cli ablate (16 pairs, K={m['budget']}): {m['recall']}", flush=True)

        # The fault-injected sweep: a child process dies after shard 0.
        ck = tmp / "faulted"
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "saccot_tpu_torch.cli.main", "threedmatch", "--ckpt", str(ck),
             "--fail-after-shard", "0"], cwd=root, capture_output=True, text=True, timeout=600)
        print(f"  cli threedmatch --fail-after-shard 0 (child process, {time.perf_counter() - t0:.1f}"
              f" s): exit {child.returncode}, {child.stdout.strip()[-80:]!r}", flush=True)
        check(child.returncode == 17, f"fault injection: exit {child.returncode}: "
              f"{child.stderr[-1500:]}")
        check(sorted(p.name for p in ck.iterdir()) == ["shard_000000.npz"],
              "fault injection: the child left other shards")
        m = run("threedmatch resumed", ["threedmatch", "--ckpt", str(ck)])
        T_res = SweepCheckpointer(str(ck)).merged()["T"][:32].astype(np.float32)
        check(m["recall"] == out["threedmatch"]["recall"],
              f"resume: recall {m['recall']} vs {out['threedmatch']['recall']}")
        check(np.array_equal(T_res, T_tdm), "resume: T differs from the uninterrupted run's")
        print(f"  cli resume: recall {m['recall']:.4f} equal to the uninterrupted run's, T bit for "
              f"bit", flush=True)

    torch.cuda.synchronize()
    _build.reset_launches()
    scaling = measure_scaling(CONFIGS["threedmatch"].params, device_counts=[1], device=dev)
    torch.cuda.synchronize()
    launches["measure_scaling"] = _build.launches()
    for name in PATH_ROWS:
        check(launches["measure_scaling"][name] > 0, f"measure_scaling: {name} was not launched")
    print(f"  measure_scaling at size 1 (N=512, 8 pairs, 5 reps): "
          f"{scaling['pairs_per_sec'][1]:.1f} pairs/s ({card})", flush=True)
    out["measure_scaling"] = scaling

    for r in rows:
        counter = r["name"].replace("_large_n", "")
        r["cli_launches"] = {k: v[counter] for k, v in launches.items() if v.get(counter)}
    print(json.dumps({"cli": out}, default=str), flush=True)
    print(f"phase 13 ok ({time.perf_counter() - t_phase:.1f} s)", flush=True)


# -- phase 14: the oracle, the stage timer and roofline, the trace, the guard --

# The __global__ functions of rows 1-4 (csrc/) and the counters of
# _build.LAUNCHES whose launches run each.
TRACE_KERNELS = {
    "two_sided_degrees_kernel": ("compat_degrees", "compat_degrees_direct", "ring_degrees",
                                 "compat_ops_two_sided"),
    "anchor_topb_kernel": ("anchor_topb", "anchor_topb_candidates", "anchor_topb_topt"),
    "solve3_kernel": ("solve3",),
    "score_kernel": ("score",),
}
# The oracle against the card, exact configuration: T per pair within these
# (rotations by `se3np.rotation_distance_deg`, which has no arccos floor;
# the CPU route at the same 4 pairs reads at most 1.0e-5 deg and 1.1e-7,
# the card 1.7e-5 deg and 1.1e-7: room of about 60 and 900 times),
# inlier counts within 1. tests/test_torch_oracle.py holds the CPU route
# to the same limits.
ORACLE_ROT_DEG, ORACLE_TRANS = 1e-3, 1e-4


def host_cpu():
    """The host CPU as /proc/cpuinfo names it (model name, vendor, family
    and model numbers of the first processor), the logical CPUs this
    process sees and torch's CPU capability."""
    import os

    import torch

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{info.get('model name', 'model not named')} (vendor {info.get('vendor_id', '?')}, "
            f"family {info.get('cpu family', '?')}, model {info.get('model', '?')}), "
            f"{os.cpu_count()} logical CPUs, {torch.backends.cpu.get_cpu_capability()}")


def trace_kernel_counts(path, window):
    """From a Chrome trace written by `utils.profiling.trace`, over the
    kernel launch calls on the host (the runtime API's, ctypes launches
    included) inside the `record_function` range `window`: {kernel function
    name: device events}, the device events of those calls and the calls.
    Fewer events than calls: the profiler dropped device records."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == window)
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    launches = [e for e in events
                if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")]
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    calls = {e["args"]["correlation"] for e in launches if t0 <= e["ts"] <= t1}
    counts, n_events = collections.Counter(), 0
    for e in kernels:
        if e["args"].get("correlation") in calls:
            n_events += 1
            m = re.search(r"\(anonymous namespace\)::(\w+)", e.get("name", ""))
            if m:
                counts[m.group(1)] += 1
    return counts, n_events, len(calls)


def phase14(dev, rows, card, fast, exact, P, Q):
    """The last four modules on the card at the bench point: (a) the NumPy
    oracle against `register_batch` (4 pairs, exact configuration); (b) one
    fast batch of 128 stage by stage under `StageTimer`, each stage's
    roofline fraction; (c) `trace()` around one fast and one exact batch,
    rows 1-4's kernels in its device events as often as they launched; (d)
    `nan_guard`: a clean fast batch keeps its bits, a NaN point raises in the
    solve on the kernel and the plain route."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from saccot_tpu_torch import register_batch
    from saccot_tpu_torch.engine import sac_cot
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import score as kscore
    from saccot_tpu_torch.kernels import solve3 as ksolve
    from saccot_tpu_torch.oracle import sac_cot as oracle_sac_cot
    from saccot_tpu_torch.utils.convert import problem_batch, recall
    from saccot_tpu_torch.utils.debug import nan_guard
    from saccot_tpu_torch.utils.profiling import StageTimer, trace
    from saccot_tpu_torch.utils.se3np import rotation_distance_deg

    t_phase = time.perf_counter()
    out = {}

    # (a) The oracle on the host against the card: seeds 1000-1003 (phase 3's
    # first four pairs), exact configuration.
    P4, Q4, T4 = problem_batch(range(1000, 1004), device=dev, n=1000, outlier_ratio=0.8,
                               noise=0.004)
    Pn, Qn = P4.cpu().numpy(), Q4.cpu().numpy()
    t0 = time.perf_counter()
    want = [oracle_sac_cot(Pn[b], Qn[b], exact) for b in range(4)]
    oracle_s = time.perf_counter() - t0
    got = register_batch(P4, Q4, exact)
    T_card = got.T.cpu().numpy().astype(np.float64)
    rec_card, rec_oracle = recall(got, T4, 5.0, 0.05), recall_np([w["T"] for w in want], T4,
                                                                 5.0, 0.05)
    check(rec_card == rec_oracle, f"oracle: recall {rec_oracle}, the card's {rec_card}")
    rot = [float(rotation_distance_deg(T_card[b][:3, :3], want[b]["T"][:3, :3]))
           for b in range(4)]
    trans = [float(np.linalg.norm(T_card[b][:3, 3] - want[b]["T"][:3, 3])) for b in range(4)]
    inl = [(int(got.num_inliers[b]), int(want[b]["num_inliers"])) for b in range(4)]
    check(max(rot) <= ORACLE_ROT_DEG and max(trans) <= ORACLE_TRANS
          and all(abs(a - b) <= 1 for a, b in inl),
          f"oracle: T differs from the card's by {rot} deg, {trans}; inliers {inl}")
    out["oracle"] = dict(pairs_per_s=4 / oracle_s, host_cpu=host_cpu(), recall=rec_oracle,
                         max_rot_deg=max(rot), max_trans=max(trans))
    print(f"  (a) oracle, 4 pairs (exact): recall {rec_oracle:.4f}, the card's {rec_card:.4f}; "
          f"T within {max(rot):.3g} deg and {max(trans):.3g} of the card's (tolerance "
          f"{ORACLE_ROT_DEG} deg, {ORACLE_TRANS}); inliers card/oracle {inl}; "
          f"triangles {[int(w['num_triangles']) for w in want]}; the oracle "
          f"{4 / oracle_s:.3f} pairs/s on the host CPU ({host_cpu()}), not the card",
          flush=True)

    # (b) One fast batch of 128 stage by stage, each stage's inputs the
    # previous stage's outputs, computed and waited for before it starts.
    batch, n = P.shape[:2]
    ones = torch.ones((batch, n), device=dev)
    timer = StageTimer()

    def staged():
        s = {}
        with timer.stage("degrees", block_on=s):
            s["deg"] = kcompat.degrees(P, Q, P, Q, fast)
        with timer.stage("pool", block_on=s):
            s["pool"] = tri_mod.triangle_pool_from_points(P, Q, s["deg"], fast)
        with timer.stage("solve", block_on=s):
            s["r9"], s["t3"] = ksolve.solve3(P, Q, s["pool"].triples)
        with timer.stage("score", block_on=s):
            s["scores"] = kscore.score_hypotheses(s["r9"], s["t3"], P, Q, fast.inlier_tau,
                                                  mode=fast.scoring)[0]
        with timer.stage("refine", block_on=s):
            _, R, t = sac_cot.best_hypothesis(s["scores"], s["pool"].valid, s["r9"], s["t3"])
            s["R"], s["t"], s["inl"] = sac_cot.refine(P, Q, R, t, fast, ones)
        return s

    staged()
    torch.cuda.synchronize()
    timer.timings.clear()
    reps = 5
    for _ in range(reps):
        s = staged()
    ref = register_batch(P, Q, fast)
    check(torch.equal(s["R"], ref.R) and torch.equal(s["t"], ref.t)
          and torch.equal(s["inl"], ref.inliers),
          "stages: the staged batch differs from register_batch")
    models = roofline.estimator_models(n, fast, batch)
    stages = {}
    for name, sec in timer.timings.items():
        fr = roofline.roofline_fraction(models[name], sec / reps)
        stages[name] = dict(ms=sec / reps * 1e3, bound_ms=roofline.stage_bound_seconds(
            models[name]) * 1e3, binding=fr["binding"], fraction=fr["fraction_of_peak"])
        print(f"  (b) {name:8s} {sec / reps * 1e3:8.4f} ms host (synced), bound "
              f"{stages[name]['bound_ms']:.4f} ms ({fr['binding']}), fraction "
              f"{fr['fraction_of_peak']:.4f}", flush=True)
    total = sum(timer.timings.values()) / reps
    flops = roofline.estimator_flop_count(n, fast, batch)
    out["stages"] = stages
    print(f"  (b) stages sum {total * 1e3:.4f} ms a batch of {batch}, bit for bit "
          f"register_batch; estimator {flops:.4g} FP32 instructions, "
          f"{flops / total:.4g}/s achieved against {roofline.PEAK_FP32_INSTRUCTIONS:.4g}/s "
          f"({card})", flush=True)

    # (c) The trace: the device events of rows 1-4's kernels, once per launch,
    # among the launches of the range that holds the two batches. One trace:
    # every launch call of the range has its device event (the capture's
    # warm-up takes the profiler's losses at its start, PERF.md section 7),
    # and each kernel's events match its counters exactly.
    logdir = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.synchronize()
    _build.reset_launches()
    with trace(str(logdir)) as path:
        with torch.profiler.record_function("phase14/batches"):
            for params in (fast, exact):
                register_batch(P, Q, params)
    launched = _build.launches()
    counts, n_events, n_calls = trace_kernel_counts(path, "phase14/batches")
    print(f"  (c) trace: {n_events} kernel events for the {n_calls} launch calls of the "
          "batches", flush=True)
    check(n_events == n_calls,
          f"trace: {n_calls - n_events} of {n_calls} launches have no kernel record")
    for kernel, counters in TRACE_KERNELS.items():
        n_launched = sum(launched[c] for c in counters)
        check(n_launched > 0 and counts[kernel] == n_launched,
              f"trace: {kernel} in {counts[kernel]} device events, launched {n_launched} times")
    for r in rows:
        if r["name"] in ("compat_degrees", "anchor_topb_candidates", "anchor_topb_topt",
                         "solve3", "score"):
            r["phase14_launches"] = launched[r["name"]]
            check(r["phase14_launches"] > 0, f"{r['name']} was not launched in phase 14")
    print(f"  (c) trace {path.name} ({path.stat().st_size} bytes): device events "
          f"{ {k: counts[k] for k in TRACE_KERNELS} } = launches {launched}", flush=True)

    # (d) The guard: a clean fast batch keeps its bits; a NaN point named by
    # triples of pair 0 raises in the solve on both routes.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with nan_guard():
        guarded = register_batch(P, Q, fast)
    guard_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(guarded, ref)),
          "guard: the guarded batch differs from the unguarded one")
    triples = s["pool"].triples
    i = int(triples[0, 0, 0])
    Pnan = P.clone()
    Pnan[0, i, 1] = float("nan")
    named = (triples[0] == i).any(dim=1)
    r9n = ksolve.solve3(Pnan, Q, triples)[0]
    check(torch.equal(torch.isnan(r9n[0]).any(dim=0), named)
          and not torch.isnan(r9n[1:]).any(), "guard: the NaN did not reach exactly the "
          "hypotheses that name its point")
    msgs = {}
    for route, solve in (("kernel", ksolve.solve3), ("plain", ksolve.solve3_reference)):
        before = _build.launches()["solve3"]
        try:
            with nan_guard():
                solve(Pnan, Q, triples)
        except FloatingPointError as e:
            msgs[route] = str(e)
            check("solve3" in str(e), f"guard: the {route} route's error names no solve: {e}")
        else:
            raise PhaseError(f"guard: a NaN point through the {route} solve did not raise")
        check(_build.launches()["solve3"] == before + (route == "kernel"),
              f"guard: the {route} route launched the solve kernel "
              f"{_build.launches()['solve3'] - before} times")
    out["guard"] = dict(guarded_ms=guard_ms, named_hypotheses=int(named.sum()), raised=msgs)
    print(f"  (d) guard: the guarded fast batch ({guard_ms:.1f} ms host) has the unguarded "
          f"bits; point {i} of pair 0 set to NaN reaches the {int(named.sum())} hypotheses "
          f"that name it; raised {msgs}", flush=True)
    print(json.dumps({"phase14": out}), flush=True)
    print(f"phase 14 ok ({time.perf_counter() - t_phase:.1f} s)", flush=True)

# -- phase 15: one stage by its plain version, the rest by their kernels ------

def staged_mix(P, Q, params, routes, where):
    """One batch stage by stage, each stage by the route `routes` names, on
    the inputs the earlier stages of that mix hand it; each stage's kernel
    held to its plain version on those inputs at phase 3's tolerances
    (degrees rtol 1e-5 / atol 1e-3, the anchor kernel as `hold_anchor`, the
    solve bit for bit, counts as `hold_score`). Returns R, t and the inliers
    the refine gives."""
    import torch

    from saccot_tpu_torch.engine import sac_cot
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import score as kscore
    from saccot_tpu_torch.kernels import solve3 as ksolve
    from saccot_tpu_torch.kernels import triangles as ktri

    kernel = {stage: route == "kernel" for stage, route in routes.items()}
    deg_k = kcompat.degrees(P, Q, P, Q, params)
    deg_p = kcompat.degrees_reference(P, Q, P, Q, params)
    torch.testing.assert_close(deg_k, deg_p, rtol=1e-5, atol=1e-3)
    deg = deg_k if kernel["compat"] else deg_p
    N = P.shape[1]
    A, B = min(params.num_anchors, N), min(params.neighbors_per_anchor, N - 1)
    _, anchors = ktri.topk_stable(deg, A)
    hold_anchor(P, Q, anchors, B, 4, params.compat_tau, params.min_separation, where)
    pool = tri_mod.triangle_pool_from_points(P, Q, deg, params, impl=routes["pool"])
    r9, t3 = ksolve.solve3(P, Q, pool.triples)
    r9_p, t3_p = ksolve.solve3_reference(P, Q, pool.triples)
    check(torch.equal(r9, r9_p) and torch.equal(t3, t3_p), f"solve3 at {where}: r9/t3 differ")
    hold_score(r9, t3, P, Q, params.inlier_tau, where)
    score_fn = kscore.score_hypotheses if kernel["score"] else kscore.score_hypotheses_reference
    scores = score_fn(r9, t3, P, Q, params.inlier_tau, mode=params.scoring)[0]
    _, R, t = sac_cot.best_hypothesis(scores, pool.valid, r9, t3)
    ones = torch.ones(P.shape[:2], device=P.device)
    return sac_cot.refine(P, Q, R, t, params, ones)


def phase15(dev, rows, fast, exact, P, Q, T_gt, results):
    """`register_batch` at the bench point (fast and exact) once for each
    single-stage mix: one of compat_impl, pool_impl, solve_impl and
    score_impl "plain", the other three "kernel". Each mix registers at
    recall >= 0.98; its plain stage launches no kernel and its kernel
    stages launch theirs; each stage is held to the version the mix names
    on the mix's own inputs (`staged_mix`, bit for bit the entry point's
    R, t and inliers); the solve_impl="plain" mix gives phase 4's
    all-kernel T bit for bit (row 3 equals its plain version bit for bit).
    Then B > 32 on the card: the pool's kernel refuses it, the plain pool
    under kernel degrees, solve and score runs it."""
    import torch

    from saccot_tpu_torch import register_batch
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.utils.convert import recall

    t_phase = time.perf_counter()
    total = dict.fromkeys(_build.LAUNCHES, 0)
    for name, params in (("fast", fast), ("exact", exact)):
        # The launch counter of each stage's kernel at the bench point (row 2
        # in the mode the configuration takes).
        counters = {"compat": "compat_degrees",
                    "pool": ("anchor_topb_topt" if params.per_anchor_candidates
                             else "anchor_topb_candidates"),
                    "solve": "solve3", "score": "score"}
        stages = tuple(counters)
        for plain in stages:
            routes = {s: "plain" if s == plain else "kernel" for s in stages}
            mix = {f"{s}_impl": r for s, r in routes.items()}
            torch.cuda.synchronize()
            _build.reset_launches()
            res = register_batch(P, Q, params, **mix)
            torch.cuda.synchronize()
            launched = _build.launches()
            total = {k: total[k] + v for k, v in launched.items()}
            where = f"the bench point, {name}, {plain}_impl='plain'"
            check(bool(torch.isfinite(res.T).all()), f"{where}: non-finite transforms")
            rec = recall(res, T_gt, 5.0, 0.05)
            check(rec >= 0.98, f"{where}: recall {rec} < 0.98")
            for s in stages:
                n = launched[counters[s]]
                check((n == 0) if s == plain else (n > 0),
                      f"{where}: {counters[s]} launched {n} times")
            # The exact pool ranks by its kernel, once a call, unless plain.
            want_rank = 0 if plain == "pool" or params.per_anchor_candidates else 1
            check(launched["pool_rank"] == want_rank,
                  f"{where}: pool_rank launched {launched['pool_rank']} times")
            # The refine follows `impl` ("kernel" in every mix).
            check(launched["refine"] == 2 * params.refine_iters + 1,
                  f"{where}: the refine launched {launched['refine']} passes")
            R, t, inl = staged_mix(P, Q, params, routes, where)
            check(torch.equal(R, res.R) and torch.equal(t, res.t) and torch.equal(inl, res.inliers),
                  f"{where}: the staged mix differs from register_batch")
            same = (res.T == results[name].T).flatten(1).all(dim=1)
            if plain == "solve":
                check(bool(same.all()), f"{where}: T differs from the all-kernel run")
            print(f"  {name}, {plain}_impl='plain': recall {rec:.4f}, T bit for bit the "
                  f"all-kernel run's on {int(same.sum())} of {len(same)} pairs, launches "
                  + ", ".join(f"{counters[s]} {launched[counters[s]]}" for s in stages),
                  flush=True)
    wide = dataclasses.replace(exact, neighbors_per_anchor=40)
    try:
        register_batch(P[:2], Q[:2], wide)
        check(False, "B=40: the pool's kernel did not refuse")
    except NotImplementedError:
        pass
    res = register_batch(P[:2], Q[:2], wide, pool_impl="plain")
    check(bool(torch.isfinite(res.T).all()), "B=40 with the plain pool: non-finite transforms")
    print("  B=40: the pool's kernel refuses it (NotImplementedError); the plain pool under "
          "the other stages' kernels registers it", flush=True)
    for r in rows:
        if r["name"] in ("compat_degrees", "anchor_topb_candidates", "anchor_topb_topt",
                         "solve3", "score", "refine"):
            r["phase15_launches"] = total[r["name"]]
    print(f"phase 15 ok ({time.perf_counter() - t_phase:.1f} s)", flush=True)


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


# The pairs phase 9 also registers alone by the per-pair forms: one of the
# TP batch (the bench point) and one of the SP batch (the 3DMatch point).
PAIR_TP, PAIR_SP = 5, 7


def phase9_rank(fast, exact, kitti, tdm):
    """One rank of phase 9 (spawned by `run_ranks`, which has already joined
    the process group): DP, TP and SP runs; results and launch counts."""
    import time

    import torch
    import torch.distributed as dist

    from saccot_tpu_torch.dist.mesh import axis_group, make_mesh
    from saccot_tpu_torch.dist.sweep import make_sweep_fn
    from saccot_tpu_torch.engine.sac_cot import (
        register_batch_sp, register_batch_tp, register_pair_sp, register_pair_tp,
    )
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
    out["pair_tp"] = register_pair_tp(P[PAIR_TP], Q[PAIR_TP], fast, axis_group(tp, "hyp"))
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
    out["pair_sp"] = register_pair_sp(P3[PAIR_SP], Q3[PAIR_SP], tdm, g)
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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is still enabled")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 ok: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from saccot_tpu_torch import SacCotParams, register_batch, register_pair
    from saccot_tpu_torch.engine import triangles as tri_mod
    from saccot_tpu_torch.kernels import _build
    from saccot_tpu_torch.kernels import compat as kcompat
    from saccot_tpu_torch.kernels import refine as krefine
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

    def row(name, source, replaces, err, ms, plain_ms, counter, model, **extra):
        b_ms, b_by = roofline.bound_ms(model)
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
        roofline.compat_degrees_model(1000, 128),
        device_ms=kernel_device_ms(lambda: kcompat.degrees(P, Q, P, Q, fast)),
        plan=degree_plan_str(128, 1000, 1000))

    _, anchors = ktri.topk_stable(deg_ref, A)
    anchor_err = hold_anchor(P, Q, anchors, B, T, tau, sep, "the bench point")
    for mode, kw, t in (("candidates", {"emit_candidates": True}, 0), ("topt", {"top_t": T}, T)):
        row(f"anchor_topb_{mode}", "saccot_tpu_torch/csrc/anchor_topb.cu",
            "saccot_tpu/kernels/triangles.py:42", anchor_err[mode],
            time_ms(lambda: ktri.anchor_neighbors(P, Q, anchors, B, tau, sep, **kw)),
            time_ms(lambda: ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep, **kw)),
            f"anchor_topb_{mode}", roofline.pool_model(1000, A, B, t, 128),
            device_ms=kernel_device_ms(lambda: ktri.anchor_neighbors(P, Q, anchors, B, tau, sep,
                                                                     **kw)),
            plan=plan_str(ktri.anchor_plan(1000, B)))

    pool = tri_mod.triangle_pool_from_points(P, Q, deg_ref, exact, impl="plain")
    triples = pool.triples
    r9, t3 = ksolve.solve3(P, Q, triples)
    r9_ref, t3_ref = ksolve.solve3_reference(P, Q, triples)
    # Solve bit for bit: the kernel spells every operation as an explicitly
    # rounded one, in the plain version's order, under every block size.
    err = max((r9 - r9_ref).abs().max().item(), (t3 - t3_ref).abs().max().item())
    check(torch.equal(r9, r9_ref) and torch.equal(t3, t3_ref), f"solve3: r9/t3 differ by {err}")
    threads = hold_solve_plans(P, Q, triples, "the bench point")
    print(f"  solve3 at the bench point: {solve_plan_str(128, triples.shape[1])}; bit for bit "
          f"in blocks of {threads}", flush=True)
    row("solve3", "saccot_tpu_torch/csrc/solve3.cu", "saccot_tpu/kernels/solve3.py:73", err,
        time_ms(lambda: ksolve.solve3(P, Q, triples)),
        time_ms(lambda: ksolve.solve3_reference(P, Q, triples)), "solve3",
        roofline.solve_model(1000, triples.shape[1], 128),
        device_ms=kernel_device_ms(lambda: ksolve.solve3(P, Q, triples)),
        plan=solve_plan_str(128, triples.shape[1]))

    hold_score(r9_ref, t3_ref, P, Q, fast.inlier_tau, "the bench point")
    row("score", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31", 0.0,
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, P, Q, fast.inlier_tau)),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, P, Q,
                                                          fast.inlier_tau)), "score",
        roofline.scoring_model(1000, r9_ref.shape[2], 128),
        device_ms=kernel_device_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, P, Q,
                                                                   fast.inlier_tau)))

    # The refine (row 12) from the plain scores' best valid hypothesis.
    scores = kscore.score_hypotheses_reference(r9_ref, t3_ref, P, Q, fast.inlier_tau)[0]
    err, Rb, tb = hold_refine(P, Q, scores, pool.valid, r9_ref, t3_ref, exact, "the bench point")
    rargs = (P, Q, Rb, tb, exact, torch.ones(P.shape[:2], device=dev))
    row("refine", "saccot_tpu_torch/csrc/refine.cu",
        "none: the refine ran in XLA (saccot_tpu/engine/sac_cot.py)", err,
        time_ms(lambda: krefine.refine(*rargs)), time_ms(lambda: krefine.refine_reference(*rargs)),
        "refine", roofline.refine_model(1000, exact.refine_iters, 128),
        device_ms=kernel_device_ms(lambda: krefine.refine(*rargs)))
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
    res3 = register_batch(P3, Q3, tdm)
    rec_k = recall(res3, T3, 15.0, 0.30)
    cli_ref = dict(threedmatch_T=res3.T.cpu().numpy(), threedmatch_recall=rec_k)
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
    threads = hold_solve_plans(P3, Q3, pool3.triples, "the 3DMatch point")
    print(f"  solve3 at the 3DMatch point: {solve_plan_str(*pool3.triples.shape[:2])}; bit for "
          f"bit in blocks of {threads}", flush=True)
    hold_score(*ksolve.solve3_reference(P3, Q3, pool3.triples), P3, Q3, tdm.inlier_tau,
               "the 3DMatch point")
    # The pool's ranking (row 13) on the fused kernel's candidates at this
    # point, and on them tiled to threedmatch.sweep's call of 1,623 pairs,
    # where it is timed.
    rank3 = (anc3.contiguous(), *ktri.anchor_neighbors(
        P3, Q3, anc3, tdm.neighbors_per_anchor, tdm.compat_tau, tdm.min_separation,
        emit_candidates=True))
    hold_pool_rank(*rank3, tdm, 2048, "the 3DMatch point")
    rank3 = tuple(tiled(x, 1623) for x in rank3)
    plan3 = hold_pool_rank(*rank3, tdm, 2048, "threedmatch.sweep's call (1,623 pairs, tiled)")
    rank3 += (tdm.max_hypotheses, True, 2048)
    row("pool_rank", "saccot_tpu_torch/csrc/pool_rank.cu",
        "none: the exact pool's dedup and top-K (XLA in saccot_tpu/engine/triangles.py)", 0.0,
        time_ms(lambda: ktri.pool_rank(*rank3)),
        time_ms(lambda: ktri.pool_rank_reference(*rank3), reps=5), "pool_rank",
        roofline.pool_rank_model(tdm.num_anchors, tdm.neighbors_per_anchor,
                                 tdm.max_hypotheses, 1623),
        device_ms=kernel_device_ms(lambda: ktri.pool_rank(*rank3)), plan=str(plan3))
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
        roofline.compat_degrees_model(50000, 2),
        device_ms=kernel_device_ms(lambda: kcompat.degrees(PK, QK, PK, QK, kp), reps=5))
    print(f"  compat_degrees two-sided kernel at the same shape: {two_sided_ms:.4f} ms, "
          f"max |tri - two-sided| {(deg - deg_2s).abs().max().item():.3g} "
          f"({degree_plan_str(2, 50000, 50000)})", flush=True)
    # Masked, as the padded cells send it: a block with no valid row or
    # column writes zero sums and leaves (`hold_tri_skips`).
    hold_tri_skips(PK, QK, kp, (41001, 25000), "kitti")
    hold_tri_skips(PK[:, :2500].contiguous(), QK[:, :2500].contiguous(), kp, (0, 2177),
                   "the 3DLoMatch shape")

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
        roofline.anchor_rows_model(50000, A, B, 2),
        device_ms=kernel_device_ms(lambda: ktri.anchor_neighbors_stream(*sargs)),
        plan=f"{plan_str(splan)}, {splan.blocks} blocks")

    # The pool's ranking (row 13) on the streamed selections' candidates, and
    # on them tiled to kitti.sweep's call of 64 pairs, where it is timed.
    rankk = (anchors.contiguous(), got[0], got[1], ktri.candidates_from_points(
        got[0], got[1], PK, QK, tau, sep, ktri.pair_slots(B, dev), anchors))
    hold_pool_rank(*rankk, kp, 50000, "kitti")
    rankk = tuple(tiled(x, 64) for x in rankk)
    plank = hold_pool_rank(*rankk, kp, 50000, "kitti.sweep's call (64 pairs, tiled)")
    rankk += (kp.max_hypotheses, True, 50000)
    row("pool_rank_large_n", "saccot_tpu_torch/csrc/pool_rank.cu",
        "none: the exact pool's dedup and top-K (XLA in saccot_tpu/engine/triangles.py)", 0.0,
        time_ms(lambda: ktri.pool_rank(*rankk)),
        time_ms(lambda: ktri.pool_rank_reference(*rankk), reps=5), "pool_rank",
        roofline.pool_rank_model(A, B, kp.max_hypotheses, 64),
        device_ms=kernel_device_ms(lambda: ktri.pool_rank(*rankk)), plan=str(plank))

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
        roofline.candidate_topt_model(A, B, T, 2),
        device_ms=kernel_device_ms(lambda: ktri.candidate_topt(*cargs)),
        plan=f"{plan_str(cplan)}, {cplan.blocks} blocks")

    # Solve and score at N=50,000 (the TPU streamed the solve above its VMEM
    # cap; the direct-index kernels take any N), score's tolerances as in
    # phase 3. The solve (row 8) bit for bit under every block size of the
    # sweep, here (the bench and 3DMatch points in phases 3 and 5).
    kpool = tri_mod.triangle_pool_from_points(PK, QK, deg_ref, kp, impl="plain")
    ktrip = kpool.triples
    r9, t3 = ksolve.solve3(PK, QK, ktrip)
    r9_ref, t3_ref = ksolve.solve3_reference(PK, QK, ktrip)
    err = max((r9 - r9_ref).abs().max().item(), (t3 - t3_ref).abs().max().item())
    check(torch.equal(r9, r9_ref) and torch.equal(t3, t3_ref),
          f"solve3 at N=50000: r9/t3 differ by {err}")
    threads = hold_solve_plans(PK, QK, ktrip, "kitti")
    print(f"  solve3 at kitti: {solve_plan_str(*ktrip.shape[:2])}; bit-identical to "
          f"solve3_reference in blocks of {threads}", flush=True)
    row("solve3_large_n", "saccot_tpu_torch/csrc/solve3.cu",
        "saccot_tpu/kernels/solve3.py:124", err,
        time_ms(lambda: ksolve.solve3(PK, QK, ktrip)),
        time_ms(lambda: ksolve.solve3_reference(PK, QK, ktrip)), "solve3",
        roofline.solve_model(50000, ktrip.shape[1], 2),
        device_ms=kernel_device_ms(lambda: ksolve.solve3(PK, QK, ktrip)),
        plan=solve_plan_str(2, ktrip.shape[1]))
    kargs = (r9_ref, t3_ref, PK, QK, kp.inlier_tau)
    hold_score(*kargs, "kitti")
    row("score_large_n", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31", 0.0,
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, PK, QK, kp.inlier_tau),
                reps=10),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, PK, QK,
                                                          kp.inlier_tau), **big), "score",
        roofline.scoring_model(50000, r9_ref.shape[2], 2),
        device_ms=kernel_device_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, PK, QK,
                                                                   kp.inlier_tau)))
    kscores = kscore.score_hypotheses_reference(*kargs)[0]
    err, Rb, tb = hold_refine(PK, QK, kscores, kpool.valid, r9_ref, t3_ref, kp, "kitti")
    rargs = (PK, QK, Rb, tb, kp, torch.ones(PK.shape[:2], device=dev))
    row("refine_large_n", "saccot_tpu_torch/csrc/refine.cu",
        "none: the refine ran in XLA (saccot_tpu/engine/sac_cot.py)", err,
        time_ms(lambda: krefine.refine(*rargs), reps=10),
        time_ms(lambda: krefine.refine_reference(*rargs), **big), "refine",
        roofline.refine_model(50000, kp.refine_iters, 2),
        device_ms=kernel_device_ms(lambda: krefine.refine(*rargs)))
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
    cli_ref.update(kitti_T=kitti_results["exact"].T.cpu().numpy(), kitti_P=PK, kitti_Q=QK,
               kitti_params=kp)
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
        "compat_degrees_direct", roofline.compat_degrees_model(2048, 32, rows=2048 - h),
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
        roofline.ring_step_model(25000, 25000, 2),
        device_ms=kernel_device_ms(lambda: kring.ring_degrees_step(*step_args)),
        plan=degree_plan_str(2, 25000, 25000))
    print(f"  ring_degrees step at the bench, d=2: kernel {bench_ms:.4f} ms, "
          f"plain {bench_plain_ms:.4f} ms, bound "
          f"{roofline.bound_ms(roofline.ring_step_model(500, 500, 128))[0]:.4f} "
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
        # The sharded refine: two passes a fit, the fit after the all-reduces,
        # and the last mask pass.
        got = (r["sp_ring_launches"]["refine"], r["sp_ring_launches"]["refine_fit"])
        want = (2 * KITTI_PARAMS.refine_iters + 1, KITTI_PARAMS.refine_iters)
        check(got == want, f"SP ring: refine passes and fits {got}, want {want}")
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
    # (e) The per-pair forms: register_pair_tp on pair PAIR_TP of the TP
    # batch, register_pair_sp on pair PAIR_SP of the 3DMatch SP batch. Every
    # field bit for bit the batch form's row: every kernel, the refine's
    # included, sums in an order fixed by the shard's N alone. TP holds one
    # rank's bits, so register_pair_tp equals register_pair on one rank.
    one_tp = register_pair(P[PAIR_TP], Q[PAIR_TP], fast)
    for r in ranks:
        for form, batch_res, b in (("pair_tp", r["tp"], PAIR_TP), ("pair_sp", r["sp_3dm"], PAIR_SP)):
            got = r[form]
            for f, x, y in zip(got._fields, got, batch_res):
                check(np.array_equal(x, y[b]),
                      f"{form} on rank {r['rank']}: {f} differs from the batch form's row {b}")
        check(all(np.array_equal(x, y.cpu().numpy()) for x, y in zip(r["pair_tp"], one_tp)),
              f"pair_tp on rank {r['rank']}: differs from register_pair on one rank")
    print(f"  (e) register_pair_tp (pair {PAIR_TP}) and register_pair_sp (pair {PAIR_SP}): "
          f"every field bit for bit the batch forms' rows; register_pair_tp bit for bit "
          f"register_pair on one rank", flush=True)
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
        b_ms, b_by = roofline.bound_ms(roofline.compat_ops_model("full", form, 50000))
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
    cli_ref["slam_ate"] = phase12(dev, rows)

    # -- phase 13: the command line ----------------------------------------
    phase13(dev, rows, cli_ref, card)

    # -- phase 14: the oracle, the stage timer and roofline, the trace, the guard
    phase14(dev, rows, card, fast, exact, P, Q)

    # -- phase 15: one stage by its plain version, the rest by their kernels
    phase15(dev, rows, fast, exact, P, Q, T_gt, results)

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
