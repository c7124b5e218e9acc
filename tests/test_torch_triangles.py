"""PyTorch port vs the JAX package: anchor top-B neighbours, candidate
triangles, the dedup mask and the triangle pool.

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

from saccot_tpu.engine import compat as jcompat
from saccot_tpu.engine import triangles as jtri
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.kernels.triangles import anchor_neighbors_pallas
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch.engine import triangles as ttri
from saccot_tpu_torch.kernels import triangles as ktri
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
EXACT = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
)
FAST = dataclasses.replace(EXACT, dedup_triangles=False, approx_topk=True,
                           per_anchor_candidates=4)
N, A, B, T = 300, 64, 10, 4


def _jax(params):
    """The JAX package's SacCotParams with the same field values."""
    return JaxSacCotParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def case():
    """Two problems, a mask, and each one's JAX degrees and anchors."""
    probs = [correspondence_problem(seed=31 + s, n=N, outlier_ratio=0.5) for s in range(2)]
    P = np.stack([p["P"] for p in probs])
    Q = np.stack([p["Q"] for p in probs])
    mask = np.ones((2, N), np.float32)
    mask[:, 260:] = 0
    anchors = []
    for b in range(2):
        deg = jcompat.degrees(jnp.asarray(P[b]), jnp.asarray(Q[b]), jnp.asarray(P[b]),
                              jnp.asarray(Q[b]), _jax(EXACT), mask_rows=jnp.asarray(mask[b]),
                              mask_cols=jnp.asarray(mask[b]))
        anchors.append(np.asarray(lax.top_k(deg, A)[1]))
    return dict(P=P, Q=Q, mask=mask, anchors=np.stack(anchors).astype(np.int64))


def _jax_neighbors(case, b, **kw):
    P, Q, m = (jnp.asarray(case[k][b]) for k in ("P", "Q", "mask"))
    anc = jnp.asarray(case["anchors"][b], jnp.int32)
    outs = anchor_neighbors_pallas(P, Q, anc, B, EXACT.compat_tau, EXACT.min_separation,
                                   mask=m, anchor_mask=m[anc], **kw)
    return [np.asarray(o) for o in outs]


def _torch_neighbors(case, **kw):
    P, Q, m = (torch.from_numpy(case[k]) for k in ("P", "Q", "mask"))
    anc = torch.from_numpy(case["anchors"])
    outs = ktri.anchor_neighbors(P, Q, anc, B, EXACT.compat_tau, EXACT.min_separation,
                                 mask=m, anchor_mask=torch.gather(m, 1, anc), **kw)
    return [o.numpy() for o in outs]


def _off_ties(s):
    """Selections whose score is not within rounding of a rank neighbour's."""
    tie = np.zeros_like(s, dtype=bool)
    tie[..., :-1] |= np.abs(s[..., :-1] - s[..., 1:]) < 2e-4
    tie[..., 1:] |= tie[..., :-1]
    return ~tie


@pytest.mark.parametrize("mode", ["neighbors", "candidates", "top_t"])
def test_anchor_neighbors_match_pallas(case, mode):
    kw = {"neighbors": {}, "candidates": {"emit_candidates": True},
          "top_t": {"top_t": T}}[mode]
    got = _torch_neighbors(case, **kw)
    for b in range(2):
        ref = _jax_neighbors(case, b, **kw)
        np.testing.assert_allclose(got[0][b], ref[0], rtol=1e-4, atol=2e-4)
        stable = _off_ties(ref[0])
        np.testing.assert_array_equal(got[1][b][stable], ref[1][stable])
        if mode == "candidates":
            np.testing.assert_allclose(got[2][b], ref[2], atol=2e-4)
        if mode == "top_t":
            np.testing.assert_allclose(got[2][b], ref[2], atol=2e-4)
            clear = _off_ties(ref[2]) & (ref[2] > 0)
            np.testing.assert_array_equal(got[3][b][clear], ref[3][clear])
            np.testing.assert_array_equal(got[4][b][clear], ref[4][clear])


@pytest.mark.parametrize("n_sel", [2, 3, 12, 16, 32])
def test_pair_slots_are_the_upper_pairs(n_sel):
    """The candidate layout, made on the device, is `np.triu_indices(B, k=1)`
    as int64."""
    b1, b2 = ktri.pair_slots(n_sel, torch.device("cpu"))
    ref = np.triu_indices(n_sel, k=1)
    assert b1.dtype == b2.dtype == torch.int64
    np.testing.assert_array_equal(b1.numpy(), ref[0])
    np.testing.assert_array_equal(b2.numpy(), ref[1])


def test_dedup_mask_equals_jax(case):
    """The gather-based dedup mask equals the JAX one-hot version exactly,
    on the same selections."""
    nbr_s, nbr_idx = _torch_neighbors(case)
    b1, b2 = np.triu_indices(B, k=1)
    got = ktri.mark_cross_anchor_duplicates(
        torch.from_numpy(case["anchors"]), torch.from_numpy(nbr_idx),
        torch.from_numpy(nbr_s > 0), torch.from_numpy(b1), torch.from_numpy(b2), N).numpy()
    assert got.any()
    for b in range(2):
        ref = jtri._mark_cross_anchor_duplicates(
            jnp.asarray(case["anchors"][b], jnp.int32), jnp.asarray(nbr_idx[b], jnp.int32),
            jnp.asarray(nbr_s[b] > 0), jnp.asarray(b1, jnp.int32), jnp.asarray(b2, jnp.int32))
        np.testing.assert_array_equal(got[b], np.asarray(ref))


@pytest.mark.parametrize("config", ["exact", "fast"])
def test_pool_matches_pallas(case, config):
    """Pool from the same JAX degrees as triangle_pool_from_points(impl="pallas")."""
    params = EXACT if config == "exact" else FAST
    P, Q = case["P"], case["Q"]
    for b in range(2):
        deg = jcompat.degrees(jnp.asarray(P[b]), jnp.asarray(Q[b]), jnp.asarray(P[b]),
                              jnp.asarray(Q[b]), _jax(params))
        ref = jtri.triangle_pool_from_points(jnp.asarray(P[b]), jnp.asarray(Q[b]), deg,
                                             _jax(params), impl="pallas")
        got = ttri.triangle_pool_from_points(torch.from_numpy(P[b:b + 1]),
                                             torch.from_numpy(Q[b:b + 1]),
                                             torch.from_numpy(np.array(deg))[None], params)
        assert got.triples.shape == (1, params.max_hypotheses, 3)
        ref_set = {tuple(t) for t, v in zip(np.asarray(ref.triples), np.asarray(ref.valid)) if v}
        got_set = {tuple(t) for t, v in zip(got.triples[0].numpy(), got.valid[0].numpy()) if v}
        assert len(ref_set) > 50
        overlap = len(ref_set & got_set) / len(ref_set)
        assert overlap > 0.95, f"pool overlap {overlap:.3f}"
        np.testing.assert_allclose(np.sort(got.scores[0].numpy())[::-1][:64],
                                   np.sort(np.asarray(ref.scores))[::-1][:64], atol=5e-4)
        if config == "exact":
            tri = got.triples[0][got.valid[0]].numpy()
            assert (tri[:, 0] < tri[:, 1]).all() and (tri[:, 1] < tri[:, 2]).all()
            assert len(got_set) == tri.shape[0]  # no duplicates survive


def test_preranked_selection_beyond_identity(case):
    """A*T > K: an exact top-K of the per-anchor candidates (lax.top_k order)."""
    params = dataclasses.replace(FAST, max_hypotheses=100)
    P, Q = (torch.from_numpy(case[k]) for k in ("P", "Q"))
    anc = torch.from_numpy(case["anchors"])
    _, _, cs, cj, ck = ktri.anchor_neighbors(P, Q, anc, B, params.compat_tau,
                                             params.min_separation, top_t=T)
    pool = ttri._pool_from_preranked(anc, cs, cj, ck, params)
    for b in range(2):
        ref_s, ref_i = lax.top_k(jnp.asarray(cs[b].reshape(-1).numpy()), 100)
        np.testing.assert_array_equal(pool.scores[b].numpy(), np.asarray(ref_s))
        ref_i = np.asarray(ref_i)
        np.testing.assert_array_equal(pool.triples[b, :, 0].numpy(),
                                      case["anchors"][b][ref_i // T])
        np.testing.assert_array_equal(pool.triples[b, :, 1].numpy(),
                                      cj[b].reshape(-1).numpy()[ref_i])


@needs_cuda
@pytest.mark.parametrize("mode", ["neighbors", "candidates", "top_t"])
def test_anchor_kernel_matches_plain_on_card(case, mode):
    kw = {"neighbors": {}, "candidates": {"emit_candidates": True},
          "top_t": {"top_t": T}}[mode]
    P, Q, m = (torch.from_numpy(case[k]).cuda() for k in ("P", "Q", "mask"))
    anc = torch.from_numpy(case["anchors"]).cuda()
    args = (P, Q, anc, B, EXACT.compat_tau, EXACT.min_separation)
    got = ktri.anchor_neighbors(*args, mask=m, anchor_mask=torch.gather(m, 1, anc), **kw)
    ref = ktri.anchor_neighbors_reference(*args, mask=m, anchor_mask=torch.gather(m, 1, anc),
                                          **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6)
    stable = torch.from_numpy(_off_ties(ref[0].cpu().numpy())).cuda()
    assert torch.equal(got[1][stable], ref[1][stable])
    for g, r in zip(got[2:3], ref[2:3]):  # candidate scores, where emitted
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
