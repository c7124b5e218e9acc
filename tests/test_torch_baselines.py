"""PyTorch port vs the JAX package: the RANSAC and edge-guided baselines and
the sampler ablation.

Both sides get the same NumPy problems. torch cannot draw `jax.random`'s
bits, so the samplers are held to the JAX package through their priority
field: the port is handed the JAX package's own draws
(`jax.random.uniform(PRNGKey(seed), (K, N))`) and must pick the same
triples. The JAX side runs as tests/test_baselines.py runs it (plain jnp,
jitted). The port's own draws are held to the paper's ordering by recall.
Kernel-vs-plain checks need a card and skip here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from saccot_tpu.engine import baselines as jbase
from saccot_tpu.engine import compat as jcompat
from saccot_tpu.engine import score as jscore
from saccot_tpu.engine.svd3 import umeyama as jumeyama
from saccot_tpu.evaluation.ablation import run_sampler_ablation as jrun_sampler_ablation
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch.engine import baselines as tbase
from saccot_tpu_torch.engine import compat as tcompat
from saccot_tpu_torch.engine import score as tscore
from saccot_tpu_torch.evaluation.ablation import format_table, run_sampler_ablation
from saccot_tpu_torch.evaluation.metrics import registration_error
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import score as kscore
from saccot_tpu_torch.kernels import solve3 as ksolve
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernels have no CPU mode")
N, K = 400, 256
PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=64, neighbors_per_anchor=12, max_hypotheses=K,
)


def _jax(params):
    return JaxSacCotParams(**dataclasses.asdict(params))


def _draws(seed, k=K, n=N):
    """The JAX package's priority field for `seed`, as NumPy."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (k, n)))


def _problem(seed, outlier_ratio=0.8, masked_tail=0, n=N):
    prob = correspondence_problem(seed=seed, n=n, outlier_ratio=outlier_ratio, noise=0.003)
    mask = np.ones((n,), np.float32)
    mask[n - masked_tail:] = 0.0
    return prob["P"], prob["Q"], mask, prob["T_gt"]


def _t(*arrays):
    return [torch.from_numpy(np.array(a))[None] for a in arrays]


@pytest.mark.parametrize("masked_tail", [0, 150])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_triples_match_jax(seed, masked_tail):
    """RANSAC triples from the JAX package's draws: identical (top 3 of the
    priority row, masked columns at -inf, ties to the lowest index)."""
    mask = np.ones((N,), np.float32)
    mask[N - masked_tail:] = 0.0
    ref = jbase._random_triples(jax.random.PRNGKey(seed), N, K, mask=jnp.asarray(mask))
    got = tbase._random_triples(*_t(_draws(seed), mask))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (mask[got.numpy()] > 0).all()


def _jax_edge_triples(P, Q, m, params, seed):
    """`saccot_tpu.engine.baselines._edge_guided`'s sampler, line for line:
    (triples [K, 3], the top-K scores, the anchors, their score rows)."""
    P, Q, m = jnp.asarray(P), jnp.asarray(Q), jnp.asarray(m)
    n, k = P.shape[0], params.max_hypotheses
    A = min(params.num_anchors, n)
    deg = jcompat.degrees(P, Q, P, Q, params, mask_rows=m, mask_cols=m,
                          block_rows=min(params.degree_block_rows, n))
    _, anchors = lax.top_k(deg, A)
    rows = jcompat.score_block(P[anchors], Q[anchors], P, Q, params, row_ids=anchors,
                               mask_rows=m[anchors], mask_cols=m)
    flat_s, flat_i = lax.top_k(rows.reshape(-1), k)
    ei = anchors[flat_i // n]
    ej = (flat_i % n).astype(jnp.int32)
    u = jax.random.uniform(jax.random.PRNGKey(seed), (k, n))
    u = jnp.where(m.astype(bool)[None, :], u, -jnp.inf)
    cols = lax.broadcasted_iota(jnp.int32, (k, n), 1)
    u = jnp.where((cols == ei[:, None]) | (cols == ej[:, None]), -jnp.inf, u)
    ek = jnp.argmax(u, axis=1).astype(jnp.int32)
    return (np.stack([ei, ej, ek], -1), np.asarray(flat_s), np.asarray(anchors),
            np.asarray(rows))


@pytest.mark.parametrize("seed,masked_tail", [(0, 0), (1, 100), (2, 0)])
def test_edge_triples_match_jax(seed, masked_tail):
    """Edge-guided (ei, ej, ek) from the JAX package's draws, anchors and
    anchor rows of the score matrix: identical, in order, with the same
    validity (flat top-K with ties to the lowest flat index, first-maximum
    completion).

    The port's own anchor rows (`score_block`) hold the top-K scores within
    1e-4 of the JAX package's: the JAX package forms distances by the Gram trick, the port
    by coordinate differences, and a score is 1 - |dp - dq| / tau with tau
    = 0.03, so a distance error of 1e-6 moves a score by 3.3e-5. The whole
    port sampler, on its own rows and degrees, keeps the same set of edges
    and the same validity."""
    P, Q, mask, _ = _problem(20 + seed, masked_tail=masked_tail)
    ref, ref_s, anchors, rows = _jax_edge_triples(P, Q, mask, _jax(PARAMS), seed)
    tP, tQ, tm = _t(P, Q, mask)
    u = _t(_draws(seed))[0]
    got, valid = tbase._complete_edges(*_t(anchors.astype(np.int64), rows), tm, u, K)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(valid[0].numpy(), ref_s > 0)
    assert (mask[got[0].numpy()] > 0).all()

    ta = torch.from_numpy(anchors.astype(np.int64))[None]
    gidx = ta[..., None].expand(1, len(anchors), 3)
    own_rows = tcompat.score_block(torch.gather(tP, 1, gidx), torch.gather(tQ, 1, gidx), tP, tQ,
                                   PARAMS, row_ids=ta, mask_rows=torch.gather(tm, 1, ta),
                                   mask_cols=tm)
    row_of = {a: r for r, a in enumerate(anchors.tolist())}
    at = ([row_of[i] for i in ref[:, 0].tolist()], ref[:, 1])
    np.testing.assert_allclose(own_rows[0].numpy()[at], ref_s, atol=1e-4)

    own, own_valid = tbase._edge_triples(tP, tQ, tm, tm, PARAMS, u, kcompat.degrees_reference)
    pair = lambda t: [tuple(sorted(e)) for e in t[:, :2].tolist()]  # noqa: E731
    assert set(pair(own[0].numpy())) == set(pair(ref))
    np.testing.assert_array_equal(own_valid[0].numpy(), ref_s > 0)


def test_solve3_on_triples_matches_jax_umeyama():
    """Row 3 on arbitrary [batch, K, 3] triples (its plain version here)
    vs the JAX package's `umeyama(P[triples], Q[triples])`, the baselines'
    solve: R and t within 1e-5, as the estimator tests hold the solve."""
    P, Q, mask, _ = _problem(30)
    triples = jbase._random_triples(jax.random.PRNGKey(3), N, K)
    R_ref, t_ref = jumeyama(jnp.asarray(P)[triples], jnp.asarray(Q)[triples])
    r9, t3 = ksolve.solve3(*_t(P, Q, np.asarray(triples, np.int64)))
    np.testing.assert_allclose(r9[0].T.reshape(K, 3, 3).numpy(), np.asarray(R_ref), atol=1e-5)
    np.testing.assert_allclose(t3[0].T.numpy(), np.asarray(t_ref), atol=1e-5)


@pytest.mark.parametrize("refine_iters", [0, 2])
def test_score_refine_matches_jax(refine_iters):
    """The shared tail on the same triples: the same best hypothesis (first
    maximum, invalid ones at -1), the same inliers and best score, T within
    1e-4."""
    P, Q, mask, _ = _problem(31, masked_tail=50)
    params = dataclasses.replace(PARAMS, refine_iters=refine_iters)
    triples = jbase._random_triples(jax.random.PRNGKey(4), N, K, mask=jnp.asarray(mask))
    valid = np.arange(K) % 5 != 0
    jP, jQ, jm = jnp.asarray(P), jnp.asarray(Q), jnp.asarray(mask)
    R, t = jumeyama(jP[triples], jQ[triples])
    ref = jbase._score_refine(R, t, jP, jQ, jm, _jax(params), jnp.asarray(valid))
    ref_scores, _ = jscore.score_hypotheses(R, t, jP, jQ, params.inlier_tau, mask=jm)
    ref_best = int(jnp.argmax(jnp.where(jnp.asarray(valid), ref_scores, -1.0)))

    tP, tQ, tm = _t(P, Q, mask)
    r9, t3 = ksolve.solve3(tP, tQ, torch.from_numpy(np.asarray(triples, np.int64))[None])
    got = tbase._score_refine(r9, t3, tP, tQ, tm, tm, params, torch.from_numpy(valid)[None],
                              kscore.score_hypotheses)
    scores, _ = kscore.score_hypotheses(r9, t3, tP, tQ, params.inlier_tau, mask=tm)
    assert int(torch.argmax(torch.where(torch.from_numpy(valid)[None], scores, -1.0))) == ref_best
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers[0]) == int(ref.num_inliers)
    assert float(got.best_score[0]) == float(ref.best_score)
    np.testing.assert_allclose(got.T[0].numpy(), np.asarray(ref.T), atol=1e-4)


@pytest.mark.parametrize("sampler", ["ransac", "edge"])
def test_register_pair_matches_jax_with_its_draws(sampler):
    """A whole pair through the seam: the port's sampler on the JAX
    package's draws vs `ransac_register_pair` / `edge_guided_register_pair`
    (jitted): the same inlier count and registration within 0.05 deg and
    1e-4. RANSAC's triples are identical; the edge-guided pool may swap
    near-tied edges (see above), which the refine absorbs here."""
    P, Q, mask, T_gt = _problem(40, outlier_ratio=0.6 if sampler == "ransac" else 0.8)
    seed = 5
    jfn = jbase.ransac_register_pair if sampler == "ransac" else jbase.edge_guided_register_pair
    tfn = tbase.ransac_register_pair if sampler == "ransac" else tbase.edge_guided_register_pair
    ref = jfn(jnp.asarray(P), jnp.asarray(Q), _jax(PARAMS), seed=seed)
    got = tfn(torch.from_numpy(P), torch.from_numpy(Q), PARAMS, u=torch.from_numpy(_draws(seed)),
              impl="plain")
    assert int(got.num_inliers) == int(ref.num_inliers)
    rot, trans = registration_error(got.T.numpy(), np.asarray(ref.T))
    assert rot < 0.05 and trans < 1e-4, (rot, trans)
    assert registration_error(got.T.numpy(), T_gt)[0] < 3.0


def test_baselines_recover_and_respect_mask():
    """tests/test_baselines.py's behaviour on the port's own draws: RANSAC at
    30% outliers and edge-guided at 80% recover the pose; a masked half
    holds no inlier."""
    P, Q, _, T_gt = _problem(5, outlier_ratio=0.3)
    res = tbase.ransac_register_pair(torch.from_numpy(P), torch.from_numpy(Q), PARAMS, seed=1)
    assert registration_error(res.T.numpy(), T_gt)[0] < 3.0 and int(res.num_inliers) > 200
    P, Q, _, T_gt = _problem(6, outlier_ratio=0.8)
    res = tbase.edge_guided_register_pair(torch.from_numpy(P), torch.from_numpy(Q), PARAMS,
                                          seed=1)
    assert registration_error(res.T.numpy(), T_gt)[0] < 3.0 and int(res.num_inliers) > 60
    P, Q, mask, T_gt = _problem(7, outlier_ratio=0.3, masked_tail=N // 2)
    for fn in (tbase.ransac_register_pair, tbase.edge_guided_register_pair):
        res = fn(torch.from_numpy(P), torch.from_numpy(Q), PARAMS, mask=torch.from_numpy(mask),
                 seed=1)
        assert not res.inliers[N // 2:].any()
        assert registration_error(res.T.numpy(), T_gt)[0] < 3.0


def test_batch_is_pairs_with_their_own_generators():
    """The batched form draws pair b from a generator seeded with seeds[b]:
    each pair of a batch equals that pair run alone."""
    probs = [_problem(50 + b, outlier_ratio=0.7) for b in range(3)]
    P = torch.from_numpy(np.stack([p[0] for p in probs]))
    Q = torch.from_numpy(np.stack([p[1] for p in probs]))
    for bfn, pfn in ((tbase.ransac_register_batch, tbase.ransac_register_pair),
                     (tbase.edge_guided_register_batch, tbase.edge_guided_register_pair)):
        batch = bfn(P, Q, PARAMS, seeds=[7, 8, 9])
        for b in range(3):
            one = pfn(P[b], Q[b], PARAMS, seed=7 + b)
            assert torch.equal(batch.T[b], one.T) and torch.equal(batch.inliers[b], one.inliers)


def test_sampler_ablation_ordering_at_high_outliers():
    """At 97% outliers a 512-triple RANSAC finds no all-inlier triple, while
    the graph-guided samplers do (refinement off): saccot registers, and
    inliers order saccot >= edge >= ransac (tests/test_baselines.py)."""
    P, Q, _, T_gt = _problem(8, outlier_ratio=0.97, n=1000)
    params = dataclasses.replace(PARAMS, num_anchors=128, max_hypotheses=512, refine_iters=0)
    out = tbase.sampler_ablation(torch.from_numpy(P), torch.from_numpy(Q), params, seed=3)
    err = {k: registration_error(v.T.numpy(), T_gt)[0] for k, v in out.items()}
    ninl = {k: int(v.num_inliers) for k, v in out.items()}
    assert err["saccot"] < 3.0, (err, ninl)
    assert ninl["saccot"] >= ninl["edge"] >= ninl["ransac"], (err, ninl)
    assert err["ransac"] > 10.0, (err, ninl)


def test_run_sampler_ablation_sweep():
    """The batched sweep at a small size: recall orders saccot >= edge >=
    random at each rate, the gap shows at 95%, and the deterministic saccot
    sampler's recall equals the JAX package's on the same problems."""
    params = dataclasses.replace(PARAMS, num_anchors=96, neighbors_per_anchor=10,
                                 max_hypotheses=128, refine_iters=0)
    kw = dict(outlier_ratios=(0.85, 0.95), n_pairs=8, n_corr=384, seed=5)
    res = run_sampler_ablation(params, device="cpu", **kw)
    rec = res["recall"]
    for r in (0.85, 0.95):
        assert rec["saccot"][r] >= rec["edge"][r] >= rec["random"][r], rec
    assert rec["saccot"][0.95] >= 0.75, rec
    assert rec["random"][0.95] <= 0.25, rec
    ref = jrun_sampler_ablation(_jax(params), samplers=("saccot",), **kw)
    assert ref["recall"]["saccot"] == rec["saccot"]
    table = format_table(res)
    assert "saccot" in table and "85%" in table
    assert res["budget"] == 128 and res["n_pairs"] == 8 and res["n_corr"] == 384


@needs_cuda
def test_baselines_kernels_match_plain_on_card():
    """On the card, rows 1, 3 and 4 and the refine (kernel route) against
    their plain versions on the same draws: RANSAC gives the same triples,
    hence the same best hypothesis, refined by the refine kernel within
    1e-5 of the plain refine (the same sums in another order) to an inlier
    set that is its own fit's; edge-guided (degrees summed in another
    order) registers within 0.1 deg of the plain route."""
    dev = torch.device("cuda", 0)
    probs = [_problem(60 + b, outlier_ratio=0.8, n=1000) for b in range(4)]
    P = torch.from_numpy(np.stack([p[0] for p in probs])).to(dev)
    Q = torch.from_numpy(np.stack([p[1] for p in probs])).to(dev)
    for fn in (tbase.ransac_register_batch, tbase.edge_guided_register_batch):
        k = fn(P, Q, PARAMS, seeds=[1, 2, 3, 4], impl="kernel")
        p = fn(P, Q, PARAMS, seeds=[1, 2, 3, 4], impl="plain")
        for b in range(4):
            assert registration_error(k.T[b].cpu().numpy(), p.T[b].cpu().numpy())[0] < 0.1
        if fn is tbase.ransac_register_batch:
            assert torch.equal(k.best_score, p.best_score)
            assert (k.T - p.T).abs().max().item() <= 1e-5
            assert torch.equal(k.inliers, tscore.inlier_mask(k.R, k.t, P, Q, PARAMS.inlier_tau))
