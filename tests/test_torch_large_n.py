"""PyTorch port vs the JAX package on the large-N path (N > 4096, the kitti
configuration's route): the symmetric degree route, the streamed top-B
neighbours, the candidate top-T from the neighbours' ids, the exact pool from
neighbours, the solve at N > 2048, and `register_batch` end to end.

The JAX side runs as tests/test_kernels.py runs it (Pallas in interpret mode
on the CPU); both sides get the same NumPy inputs. Kernel-vs-plain checks
need a card and skip here.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from saccot_tpu.cli.configs import CONFIGS
from saccot_tpu.engine import compat as jcompat
from saccot_tpu.engine import triangles as jtri
from saccot_tpu.engine.sac_cot import register_batch as jregister_batch
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.kernels.compat import degrees_pallas
from saccot_tpu.kernels.solve3 import solve3_pallas_soa
from saccot_tpu.kernels.triangles import (
    anchor_neighbors_stream_pallas, candidate_topt_pallas,
)
from saccot_tpu.utils import se3np
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch import register_batch
from saccot_tpu_torch.engine import triangles as ttri
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import solve3 as ksolve
from saccot_tpu_torch.kernels import triangles as ktri
from saccot_tpu_torch.utils.convert import (
    KITTI_CRITERION, KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch, recall,
    result_to_numpy,
)
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
)
FAST = dataclasses.replace(PARAMS, dedup_triangles=False, approx_topk=True,
                           per_anchor_candidates=4)
N, A, B, T = 300, 64, 10, 4


def _jax(params):
    """The JAX package's SacCotParams with the same field values."""
    return JaxSacCotParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def case():
    """Two problems at N=300, a mask, each one's JAX degrees and anchors, and
    the JAX streamed selections (three column tiles of 128)."""
    probs = [correspondence_problem(seed=51 + s, n=N, outlier_ratio=0.5) for s in range(2)]
    P = np.stack([p["P"] for p in probs])
    Q = np.stack([p["Q"] for p in probs])
    mask = np.ones((2, N), np.float32)
    mask[:, 260:] = 0
    anchors, nbr_s, nbr_idx = [], [], []
    for b in range(2):
        Pj, Qj, mj = jnp.asarray(P[b]), jnp.asarray(Q[b]), jnp.asarray(mask[b])
        deg = jcompat.degrees(Pj, Qj, Pj, Qj, _jax(PARAMS), mask_rows=mj, mask_cols=mj)
        anc = lax.top_k(deg, A)[1]
        s, i = anchor_neighbors_stream_pallas(Pj, Qj, anc, B, PARAMS.compat_tau,
                                              PARAMS.min_separation, mask=mj,
                                              anchor_mask=mj[anc], tile_n=128)
        anchors.append(np.asarray(anc))
        nbr_s.append(np.asarray(s))
        nbr_idx.append(np.asarray(i))
    return dict(P=P, Q=Q, mask=mask, anchors=np.stack(anchors).astype(np.int64),
                nbr_s=np.stack(nbr_s), nbr_idx=np.stack(nbr_idx).astype(np.int64))


def _t(case, *keys):
    return [torch.from_numpy(case[k]) for k in keys]


def _off_ties(s, gap=2e-4):
    """Selections whose score is not within rounding of a rank neighbour's."""
    tie = np.zeros_like(s, dtype=bool)
    close = np.abs(s[..., :-1] - s[..., 1:]) < gap
    tie[..., :-1] |= close
    tie[..., 1:] |= close
    return ~tie


# -- degrees: the symmetric route ------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_degrees_tri_route_matches_pallas(masked):
    """The port's degrees on the symmetric route vs the JAX package's
    `_degree_kernel_mxu_tri` (interpret mode) at N=2,500, rtol 1e-5 / atol
    2e-3 as tests/test_kernels.py holds the tri kernel to the two-sided one
    (the Gram distances differ from direct differences by rounding)."""
    n = 2500
    prob = correspondence_problem(seed=9, n=n, outlier_ratio=0.6)
    mask = (np.arange(n) % 5 != 0).astype(np.float32) if masked else None
    P, Q = torch.from_numpy(prob["P"])[None], torch.from_numpy(prob["Q"])[None]
    m = None if mask is None else torch.from_numpy(mask)[None]
    assert kcompat._is_symmetric(P, Q, P, Q, 0, m, m)
    got = kcompat.degrees(P, Q, P, Q, PARAMS, mask_rows=m, mask_cols=m)[0].numpy()
    Pj, Qj = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mj = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(degrees_pallas(Pj, Qj, Pj, Qj, _jax(PARAMS), mask_rows=mj, mask_cols=mj))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-3)
    assert np.array_equal(kcompat.degrees_tri(P, Q, PARAMS, mask=m)[0].numpy(), got)


def test_degrees_tri_route_conditions():
    """Each routing condition is tested on its own; a row offset that is not
    the Python int 0 never takes the symmetric route."""
    P, Q = torch.zeros(1, 2049, 3), torch.zeros(1, 2049, 3)
    m = torch.ones(1, 2049)
    sym = kcompat._is_symmetric
    assert sym(P, Q, P, Q, 0, None, None) and sym(P, Q, P, Q, 0, m, m)
    assert not sym(P, Q, P.clone(), Q, 0, None, None)
    assert not sym(P, Q, P, Q.clone(), 0, None, None)
    assert not sym(P, Q, P, Q, 0, m, None)
    assert not sym(P, Q, P, Q, 0, m, m.clone())
    for off in (1, torch.tensor(0), np.int64(0), False, 0.0):
        assert not sym(P, Q, P, Q, off, None, None)
    small = torch.zeros(1, 2048, 3)
    assert not sym(small, small, small, small, 0, None, None)


# -- streamed top-B neighbours ----------------------------------------------

def test_anchor_neighbors_stream_matches_pallas(case):
    """Plain streamed top-B vs `anchor_neighbors_stream_pallas(tile_n=128)`
    (three column tiles at N=300). Scores within atol 2e-5: XLA may contract
    the squared distance into FMAs, and a few ulps of a distance become
    1/tau = 33 times as many in the score. Indices equal wherever the
    selection is a real (score > 0) column off ties (the last slot also
    against the first column left out, from a top-(B+1))."""
    P, Q, m, anc = _t(case, "P", "Q", "mask", "anchors")
    args = (P, Q, anc, B, PARAMS.compat_tau, PARAMS.min_separation)
    kw = dict(mask=m, anchor_mask=torch.gather(m, 1, anc))
    got_s, got_i = ktri.anchor_neighbors_stream(*args, **kw)
    np.testing.assert_allclose(got_s.numpy(), case["nbr_s"], rtol=0, atol=2e-5)
    wider = ktri.anchor_neighbors_reference(*args[:3], B + 1, *args[4:], **kw)[0].numpy()
    real = (case["nbr_s"] > 0) & _off_ties(wider, 2e-5)[..., :B]
    assert real.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[real], case["nbr_idx"][real])


def test_stream_then_candidates_equal_fused(case):
    """Streamed neighbours + candidate top-T give the fused top-T mode's
    outputs exactly (plain versions, same selections)."""
    P, Q, m, anc = _t(case, "P", "Q", "mask", "anchors")
    args = (P, Q, anc, B, PARAMS.compat_tau, PARAMS.min_separation)
    kw = dict(mask=m, anchor_mask=torch.gather(m, 1, anc))
    fused = ktri.anchor_neighbors(*args, **kw, top_t=T)
    nbr_s, nbr_idx = ktri.anchor_neighbors_stream(*args, **kw)
    got = ktri.candidate_topt(nbr_s, nbr_idx, P, Q, T, PARAMS.compat_tau, PARAMS.min_separation)
    for g, f in zip((nbr_s, nbr_idx) + got, fused):
        assert torch.equal(g, f)


# -- candidate top-T ---------------------------------------------------------

def test_candidate_topt_matches_pallas(case):
    """`candidate_topt_reference` (which reads the neighbours' coordinates by
    id) vs `candidate_topt_pallas` (given them gathered, as its TPU wrapper
    gathers them) on the same streamed selections: scores rtol/atol 1e-5 (as
    tests/test_kernels.py holds the fused and streamed TPU kernels), node ids
    equal for real candidates off ties."""
    P, Q = case["P"], case["Q"]
    nbr_s, nbr_idx = _t(case, "nbr_s", "nbr_idx")
    got = [x.numpy() for x in ktri.candidate_topt_reference(
        nbr_s, nbr_idx, torch.from_numpy(P), torch.from_numpy(Q), T, PARAMS.compat_tau,
        PARAMS.min_separation)]
    for b in range(2):
        idx = jnp.asarray(case["nbr_idx"][b], jnp.int32)
        ref = [np.asarray(x) for x in candidate_topt_pallas(
            jnp.asarray(case["nbr_s"][b]), idx, jnp.asarray(P[b])[idx], jnp.asarray(Q[b])[idx],
            T, PARAMS.compat_tau, PARAMS.min_separation)]
        np.testing.assert_allclose(got[0][b], ref[0], rtol=1e-5, atol=1e-5)
        clear = _off_ties(ref[0]) & (ref[0] > 0)
        assert clear.mean() > 0.3
        np.testing.assert_array_equal(got[1][b][clear], ref[1][clear])
        np.testing.assert_array_equal(got[2][b][clear], ref[2][clear])


# -- the exact pool from neighbours ------------------------------------------

@pytest.mark.parametrize("dedup", [True, False])
def test_pool_from_neighbors_matches_jax(case, dedup):
    """Torch `_pool_from_neighbors` (+ dedup + rank) vs the JAX function on
    the same (anchors, nbr_s, nbr_idx), with a budget that holds every valid
    candidate: the same valid-triple set and scores within 1e-5, apart from
    candidates whose s_jk sits within rounding of tau or min_separation (the
    port uses direct differences, JAX `jnp.linalg.norm`)."""
    params = dataclasses.replace(PARAMS, max_hypotheses=A * B * (B - 1) // 2,
                                 dedup_triangles=dedup)
    P, Q = case["P"], case["Q"]
    anc, nbr_s, nbr_idx = _t(case, "anchors", "nbr_s", "nbr_idx")
    got = ttri._pool_from_neighbors(anc, nbr_s, nbr_idx, torch.from_numpy(P),
                                    torch.from_numpy(Q), params)
    for b in range(2):
        ref = jtri._pool_from_neighbors(
            jnp.asarray(case["anchors"][b], jnp.int32), jnp.asarray(case["nbr_s"][b]),
            jnp.asarray(case["nbr_idx"][b], jnp.int32), jnp.asarray(P[b]), jnp.asarray(Q[b]),
            _jax(params))
        ref_map = {tuple(t): s for t, s, v in zip(np.asarray(ref.triples),
                                                  np.asarray(ref.scores),
                                                  np.asarray(ref.valid)) if v}
        got_map = {tuple(t): s for t, s, v in zip(got.triples[b].numpy(),
                                                  got.scores[b].numpy(),
                                                  got.valid[b].numpy()) if v}
        assert len(ref_map) > 100
        flips = set(ref_map) ^ set(got_map)
        assert len(flips) <= len(ref_map) // 200, flips
        for tri in set(ref_map) & set(got_map):
            assert abs(ref_map[tri] - got_map[tri]) <= 1e-5
        if dedup:
            tri = got.triples[b][got.valid[b]].numpy()
            assert (tri[:, 0] < tri[:, 1]).all() and (tri[:, 1] < tri[:, 2]).all()
            assert len(got_map) == tri.shape[0]  # no duplicates survive


@pytest.mark.parametrize("config", ["exact", "fast"])
def test_large_n_route_equals_fused_route(case, config, monkeypatch):
    """With the routing threshold lowered below N, the pool goes through the
    streamed route; on the same degrees it equals the fused route's pool."""
    params = PARAMS if config == "exact" else FAST
    P, Q, m = _t(case, "P", "Q", "mask")
    deg = kcompat.degrees(P, Q, P, Q, params, mask_rows=m, mask_cols=m)
    fused = ttri.triangle_pool_from_points(P, Q, deg, params, mask=m)
    monkeypatch.setattr(ktri, "MAX_N_FUSED", N - 1)
    streamed = ttri.triangle_pool_from_points(P, Q, deg, params, mask=m)
    assert streamed.valid.sum() > 100
    for g, f in zip(streamed, fused):
        assert torch.equal(g, f)


# -- solve at N > 2048 --------------------------------------------------------

def test_solve3_matches_stream_pallas():
    """The port's solve (direct-index loads, no N cap) vs
    `solve3_pallas_soa` at N=3,048 > MAX_N_SOLVE, where the JAX package
    streams point blocks through `_solve_stream_kernel`; atol 2e-5 as
    tests/test_kernels.py holds the stream kernel."""
    rng = np.random.default_rng(77)
    n, k = 3048, 200
    prob = correspondence_problem(seed=77, n=n, outlier_ratio=0.5, n_points=2 * n)
    triples = np.stack([rng.choice(n, size=3, replace=False) for _ in range(k)])
    r9, t3 = ksolve.solve3(torch.from_numpy(prob["P"])[None], torch.from_numpy(prob["Q"])[None],
                           torch.from_numpy(triples.astype(np.int64))[None])
    ref_r9, ref_t3 = solve3_pallas_soa(jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]),
                                       jnp.asarray(triples, jnp.int32))
    np.testing.assert_allclose(r9[0].numpy(), np.asarray(ref_r9), atol=2e-5)
    np.testing.assert_allclose(t3[0].numpy(), np.asarray(ref_t3), atol=2e-5)


# -- end to end ---------------------------------------------------------------

@pytest.mark.parametrize("config", ["exact", "fast"])
def test_register_batch_large_n_matches_jax(config):
    """`register_batch` (plain) vs the JAX package's (all four stages on
    Pallas, interpret mode) above MAX_N_FUSED: < 0.1 deg apart and inlier
    counts within 1, as tests/test_kernels.py holds its large-N path."""
    n = 4496
    params = PARAMS if config == "exact" else FAST
    P, Q, T_gt = problem_batch([78], device="cpu", n=n, outlier_ratio=0.7, n_points=2 * n)
    got = result_to_numpy(register_batch(P, Q, params, impl="plain"))
    ref = jregister_batch(jnp.asarray(P.numpy()), jnp.asarray(Q.numpy()), _jax(params),
                          compat_impl="pallas", score_impl="pallas", pool_impl="pallas",
                          solve_impl="pallas")
    E = got.T[0].astype(np.float64) @ np.linalg.inv(np.asarray(ref.T[0], np.float64))
    assert se3np.rotation_angle_deg(E[:3, :3]) < 0.1
    assert abs(int(got.num_inliers[0]) - int(ref.num_inliers[0])) <= 1
    assert bool(got.success[0]) and bool(ref.success[0])
    assert recall(register_batch(P, Q, params), T_gt, 5.0, 0.05) == 1.0


def test_kitti_problems_match_the_runner():
    """KITTI_PARAMS restate the kitti run configuration, and
    `kitti_problem_batch` builds `run_kitti_config`'s problems (here at a
    small n)."""
    cfg = CONFIGS["kitti"]
    assert dataclasses.asdict(KITTI_PARAMS) == dataclasses.asdict(cfg.params)
    assert KITTI_SEED == cfg.seed
    assert KITTI_CRITERION == (cfg.rot_thresh_deg, cfg.trans_thresh)
    n = 400
    P, Q, T_gt = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device="cpu", n=n)
    assert P.shape == Q.shape == (2, n, 3) and P.dtype == torch.float32
    for s in range(2):
        prob = correspondence_problem(seed=cfg.seed + s, n=n, outlier_ratio=cfg.outlier_ratio,
                                      noise=cfg.noise / 30.0, n_points=4 * n, max_angle=0.3,
                                      max_trans=3.0)
        np.testing.assert_array_equal(P[s].numpy(), prob["P"] * 30.0)
        np.testing.assert_array_equal(Q[s].numpy(), prob["Q"] * 30.0)
        np.testing.assert_array_equal(T_gt[s][:3, :3], prob["T_gt"][:3, :3])
        np.testing.assert_array_equal(T_gt[s][:3, 3], prob["T_gt"][:3, 3] * 30.0)


# -- the kernels on the card ----------------------------------------------------

@pytest.fixture(scope="module")
def card_case():
    """Two problems at N=3,000 on the card (two degree tiles' worth of rows
    above TRI_MIN_ROWS, three stream chunks of 1,024), with a mask."""
    P, Q, _ = problem_batch([61, 62], device="cuda", n=3000, outlier_ratio=0.6)
    mask = torch.ones((2, 3000), device="cuda")
    mask[:, ::7] = 0
    return P, Q, mask


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
def test_degrees_tri_kernel_matches_plain_on_card(card_case, masked):
    P, Q, mask = card_case
    m = mask if masked else None
    got = kcompat.degrees(P, Q, P, Q, PARAMS, mask_rows=m, mask_cols=m)
    ref = kcompat.degrees_reference(P, Q, P, Q, PARAMS, mask_rows=m, mask_cols=m)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-3)
    assert torch.equal(kcompat.degrees_tri(P, Q, PARAMS, mask=m), got)  # deterministic
    two_sided = kcompat.degrees_two_sided(P, Q, P, Q, PARAMS, mask_rows=m, mask_cols=m)
    torch.testing.assert_close(got, two_sided, rtol=1e-5, atol=2e-3)


@needs_cuda
def test_stream_kernel_matches_fused_and_plain_on_card(card_case):
    P, Q, mask = card_case
    deg = kcompat.degrees_reference(P, Q, P, Q, PARAMS, mask_rows=mask, mask_cols=mask)
    anc = ktri.topk_stable(deg, A)[1]
    args = (P, Q, anc, B, PARAMS.compat_tau, PARAMS.min_separation)
    kw = dict(mask=mask, anchor_mask=torch.gather(mask, 1, anc))
    got = ktri.anchor_neighbors_stream(*args, **kw, chunk_n=1024)
    fused = ktri.anchor_neighbors(*args, **kw)
    assert torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1])
    ref = ktri.anchor_neighbors_reference(*args, **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6)
    stable = torch.from_numpy(_off_ties(ref[0].cpu().numpy(), 1e-6)).cuda()
    assert torch.equal(got[1][stable], ref[1][stable])


@needs_cuda
def test_candidate_topt_kernel_matches_fused_and_plain_on_card(card_case):
    P, Q, mask = card_case
    deg = kcompat.degrees_reference(P, Q, P, Q, PARAMS)
    anc = ktri.topk_stable(deg, A)[1]
    nbr_s, nbr_idx, *fused = ktri.anchor_neighbors(P, Q, anc, B, PARAMS.compat_tau,
                                                   PARAMS.min_separation, top_t=T)
    cargs = (nbr_s, nbr_idx, P, Q, T, PARAMS.compat_tau, PARAMS.min_separation)
    got = ktri.candidate_topt(*cargs)
    for g, f in zip(got, fused):
        assert torch.equal(g, f)
    ref = ktri.candidate_topt_reference(*cargs)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    clear = torch.from_numpy(_off_ties(ref[0].cpu().numpy(), 1e-6)).cuda() & (ref[0] > 0)
    assert torch.equal(got[1][clear], ref[1][clear]) and torch.equal(got[2][clear], ref[2][clear])


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_candidate_topt_every_plan_equals_fused_on_card(card_case, warps, masked):
    """Every W of the sweep gives the fused top-T mode's bits on the fused
    kernel's own selections (the same device functions at the same warp
    scope), and each half of the anchors run alone the full call's."""
    P, Q, mask = card_case
    deg = kcompat.degrees_reference(P, Q, P, Q, PARAMS)
    anc = ktri.topk_stable(deg, A)[1]
    kw = dict(mask=mask, anchor_mask=torch.gather(mask, 1, anc)) if masked else {}
    nbr_s, nbr_idx, *fused = ktri.anchor_neighbors(P, Q, anc, B, PARAMS.compat_tau,
                                                   PARAMS.min_separation, **kw, top_t=T)
    plan = ktri.make_candidate_plan(2, A, B, warps)
    args = (P, Q, T, PARAMS.compat_tau, PARAMS.min_separation)
    got = ktri._candidate(nbr_s, nbr_idx, *args, plan)
    assert all(torch.equal(g, f) for g, f in zip(got, fused))
    for lo, hi in ((0, A // 2), (A // 2, A)):
        part = ktri._candidate(nbr_s[:, lo:hi].contiguous(), nbr_idx[:, lo:hi].contiguous(),
                               *args, ktri.make_candidate_plan(2, hi - lo, B, warps))
        assert all(torch.equal(g, f[:, lo:hi]) for g, f in zip(part, fused))


@needs_cuda
@pytest.mark.parametrize("top_t", [32, 33, 45])
def test_candidate_topt_more_rounds_than_lanes_on_card(card_case, top_t):
    """Past 32 rounds the selection runs a second pass over what the first
    left: the fused top-T mode's bits, and the plain version's ranking off
    ties (B=10: 45 candidate pairs an anchor, every one of them at 45)."""
    P, Q, _ = card_case
    anc = ktri.topk_stable(kcompat.degrees_reference(P, Q, P, Q, PARAMS), A)[1]
    nbr_s, nbr_idx, *fused = ktri.anchor_neighbors(P, Q, anc, B, PARAMS.compat_tau,
                                                   PARAMS.min_separation, top_t=top_t)
    cargs = (nbr_s, nbr_idx, P, Q, top_t, PARAMS.compat_tau, PARAMS.min_separation)
    got = ktri.candidate_topt(*cargs)
    assert all(torch.equal(g, f) for g, f in zip(got, fused))
    ref = ktri.candidate_topt_reference(*cargs)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    clear = torch.from_numpy(_off_ties(ref[0].cpu().numpy(), 1e-6)).cuda() & (ref[0] > 0)
    assert clear.any()
    assert torch.equal(got[1][clear], ref[1][clear]) and torch.equal(got[2][clear], ref[2][clear])


@needs_cuda
@pytest.mark.parametrize("config", ["exact", "fast"])
def test_register_batch_large_n_kernels_match_plain_on_card(config):
    params = PARAMS if config == "exact" else FAST
    P, Q, T_gt = problem_batch([78, 79], device="cuda", n=4496, outlier_ratio=0.7,
                               n_points=2 * 4496)
    got = register_batch(P, Q, params)
    ref = register_batch(P, Q, params, impl="plain")
    assert recall(got, T_gt, 5.0, 0.05) == recall(ref, T_gt, 5.0, 0.05) == 1.0
    assert (got.num_inliers - ref.num_inliers).abs().max() <= 1
