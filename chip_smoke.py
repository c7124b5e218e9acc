#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the SAC-COT estimator once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. require a CUDA device; print the card's name and power limit; turn TF32
     off for matmuls and cuDNN;
  2. build the kernels from saccot_tpu_torch/csrc (one nvcc call);
  3. each kernel against its plain PyTorch version on the card, at the bench
     shapes (batch 128, N=1000, A=256, B=12, K=1024), with the stated
     tolerances, and the median time of each over CUDA-event-timed reps;
  4. `register_batch` at the bench point (128 planted pairs, seeds 1000+s,
     80% outliers, noise 0.004) in the fast and the exact configuration:
     recall under the 5 deg / 0.05 criterion, launch counts of every kernel
     during that run, and pairs/s;
  5. the 3DMatch sweep point (32 pairs, seeds 300+s, N=2048, 90% outliers,
     noise 0.01, exact configuration, 15 deg / 0.30 criterion) through the
     kernels and through the plain versions on the card;
  6. the large-N kernels against their plain versions at the kitti shapes
     (batch 2, N=50,000, A=512, B=16, T=4, K=2048): the symmetric degree
     kernel (also bit-identical across two calls, and against the two-sided
     kernel), the streamed top-B (also bit-identical to the fused kernel at
     N=3,000 over three column tiles), the candidate top-T (also against the
     fused kernel's top-T mode), and the solve and score kernels at N=50,000;
  7. `register_batch` at the kitti configuration (seeds 500-501, 70%
     outliers, 5 deg / 0.6 m criterion), exact and fast variant, through the
     kernels and through the plain versions: recall, inliers per pair, ms per
     pair and the launch counts of every kernel during the kernel runs.
The line before the last is a JSON table of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, reps=20, warmup=3):
    """Median milliseconds of `fn` over CUDA-event-timed reps after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def off_ties(s, gap):
    """[..., B] mask of selections whose score differs from both rank
    neighbours' by at least `gap` (ties may legally swap indices)."""
    import torch

    tie = torch.zeros_like(s, dtype=torch.bool)
    close = (s[..., :-1] - s[..., 1:]).abs() < gap
    tie[..., :-1] |= close
    tie[..., 1:] |= close
    return ~tie


def main():
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

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 ok: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

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

    def row(name, source, replaces, err, ms, plain_ms, counter):
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         counter=counter, max_abs_err=err, ms=ms, plain_ms=plain_ms))
        print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)

    # Degrees: rtol 1e-5, atol 1e-3 — the kernel sums each row in column
    # order, the plain version in torch's reduction order.
    deg = kcompat.degrees(P, Q, P, Q, fast)
    deg_ref = kcompat.degrees_reference(P, Q, P, Q, fast)
    torch.testing.assert_close(deg, deg_ref, rtol=1e-5, atol=1e-3)
    row("compat_degrees", "saccot_tpu_torch/csrc/compat_degrees.cu",
        "saccot_tpu/kernels/compat.py:96", (deg - deg_ref).abs().max().item(),
        time_ms(lambda: kcompat.degrees(P, Q, P, Q, fast)),
        time_ms(lambda: kcompat.degrees_reference(P, Q, P, Q, fast)), "compat_degrees")

    _, anchors = ktri.topk_stable(deg_ref, A)
    for mode, kw in (("candidates", {"emit_candidates": True}), ("topt", {"top_t": T})):
        got = ktri.anchor_neighbors(P, Q, anchors, B, tau, sep, **kw)
        ref = ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep, **kw)
        # Top-B scores exact to 1e-6: both sides evaluate the one predicate
        # with the same unfused operations. Indices must agree wherever the
        # neighbouring scores are not within 1e-6 (ties may swap).
        err_s = (got[0] - ref[0]).abs().max().item()
        check(err_s <= 1e-6, f"anchor_topb {mode}: top-B scores differ by {err_s}")
        clear = off_ties(ref[0], 1e-6)
        check(torch.equal(got[1][clear], ref[1][clear]), f"anchor_topb {mode}: indices differ")
        # Candidates atol 1e-5 (sums of three scores of equal operations).
        err_c = (got[2] - ref[2]).abs().max().item()
        check(err_c <= 1e-5, f"anchor_topb {mode}: candidates differ by {err_c}")
        if mode == "topt":
            clear_t = off_ties(ref[2], 1e-6) & (ref[2] > 0)
            check(torch.equal(got[3][clear_t], ref[3][clear_t])
                  and torch.equal(got[4][clear_t], ref[4][clear_t]),
                  "anchor_topb topt: decoded node ids differ")
        row(f"anchor_topb_{mode}", "saccot_tpu_torch/csrc/anchor_topb.cu",
            "saccot_tpu/kernels/triangles.py:42", max(err_s, err_c),
            time_ms(lambda: ktri.anchor_neighbors(P, Q, anchors, B, tau, sep, **kw)),
            time_ms(lambda: ktri.anchor_neighbors_reference(P, Q, anchors, B, tau, sep, **kw)),
            f"anchor_topb_{mode}")

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
        time_ms(lambda: ksolve.solve3_reference(P, Q, triples)), "solve3")

    _, counts = kscore.score_hypotheses(r9_ref, t3_ref, P, Q, fast.inlier_tau)
    _, counts_ref = kscore.score_hypotheses_reference(r9_ref, t3_ref, P, Q, fast.inlier_tau)
    # Counts identical for every hypothesis: the kernel rounds each operation
    # of the residual on its own, as the plain version does (no FMA).
    diff = (counts - counts_ref).abs()
    same = (diff == 0).float().mean().item()
    check(diff.max().item() == 0,
          f"score: counts identical for {same:.5f}, max diff {diff.max().item()}")
    row("score", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31",
        float(diff.max().item()),
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, P, Q, fast.inlier_tau)),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, P, Q,
                                                          fast.inlier_tau)), "score")
    print(f"phase 3 ok: counts identical for {same:.5f} of hypotheses", flush=True)

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
        "compat_degrees_tri")
    print(f"  compat_degrees two-sided kernel at the same shape: {two_sided_ms:.4f} ms, "
          f"max |tri - two-sided| {(deg - deg_2s).abs().max().item():.3g}", flush=True)

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
        time_ms(lambda: ktri.anchor_neighbors_reference(*sargs), **big), "anchor_topb_stream")

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
        time_ms(lambda: ktri.candidate_topt_reference(*cargs)), "candidate_topt")

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
        time_ms(lambda: ksolve.solve3_reference(PK, QK, ktrip)), "solve3")
    _, counts = kscore.score_hypotheses(r9_ref, t3_ref, PK, QK, kp.inlier_tau)
    _, counts_ref = kscore.score_hypotheses_reference(r9_ref, t3_ref, PK, QK, kp.inlier_tau)
    diff = (counts - counts_ref).abs()
    same = (diff == 0).float().mean().item()
    check(diff.max().item() == 0,
          f"score at N=50000: counts identical for {same:.5f}, max diff {diff.max().item()}")
    row("score_large_n", "saccot_tpu_torch/csrc/score.cu", "saccot_tpu/kernels/score.py:31",
        float(diff.max().item()),
        time_ms(lambda: kscore.score_hypotheses(r9_ref, t3_ref, PK, QK, kp.inlier_tau),
                reps=10),
        time_ms(lambda: kscore.score_hypotheses_reference(r9_ref, t3_ref, PK, QK,
                                                          kp.inlier_tau), **big), "score")
    print(f"phase 6 ok: score counts identical for {same:.5f} of hypotheses", flush=True)

    # -- phase 7: register_batch at the kitti configuration --------------------
    rot_deg, trans_m = KITTI_CRITERION
    planted = 50000 - round(50000 * 0.7)
    kit_launches = {k: 0 for k in _build.LAUNCHES}
    for name, params in (("exact", kp), ("fast", kfast)):
        _build.reset_launches()
        res = register_batch(PK, QK, params)
        torch.cuda.synchronize()
        launched = _build.launches()
        for k, v in launched.items():
            kit_launches[k] += v
        check(bool(torch.isfinite(res.T).all()) and res.T.shape == (2, 4, 4),
              f"kitti {name}: non-finite or misshapen transforms")
        rec = recall(res, TK, rot_deg, trans_m)
        inl = res.num_inliers.tolist()
        check(rec == 1.0, f"kitti {name}: recall {rec} < 1.0")
        check(all(abs(n - planted) <= 0.01 * planted for n in inl),
              f"kitti {name}: inliers {inl} not within 1% of {planted}")
        res_p = register_batch(PK, QK, params, impl="plain")
        rec_p = recall(res_p, TK, rot_deg, trans_m)
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
