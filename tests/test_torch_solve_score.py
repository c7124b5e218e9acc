"""PyTorch port vs the JAX package: 3-point solves, weighted Umeyama,
hypothesis scoring and inlier masks.

The JAX side runs as tests/test_kernels.py runs it (Pallas in interpret mode
on the CPU); both sides get the same NumPy inputs. Kernel-vs-plain checks
need a card and skip here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from saccot_tpu.engine import score as jscore
from saccot_tpu.engine.svd3 import umeyama as jumeyama
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.kernels.score import score_hypotheses_pallas_soa
from saccot_tpu.kernels.solve3 import solve3_pallas_soa
from saccot_tpu.oracle import saccot as oracle
from saccot_tpu.utils import se3np
from saccot_tpu_torch.engine import score as tscore
from saccot_tpu_torch.engine.svd3 import transform_from_rt, umeyama
from saccot_tpu_torch.kernels import score as kscore
from saccot_tpu_torch.kernels import solve3 as ksolve

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
N, K, TAU = 300, 200, 0.03


@pytest.fixture(scope="module")
def case():
    """Two problems, random distinct triples and a batch of hypotheses near
    each problem's ground truth (so counts are far from zero)."""
    rng = np.random.default_rng(7)
    probs = [correspondence_problem(seed=41 + s, n=N, outlier_ratio=0.5) for s in range(2)]
    triples = np.stack([
        np.stack([rng.choice(N, size=3, replace=False) for _ in range(K)]) for _ in range(2)
    ]).astype(np.int64)
    Rs, ts = [], []
    for p in probs:
        Tk = [se3np.make_T(se3np.exp_so3(rng.normal(scale=0.01, size=3)),
                           rng.normal(scale=0.005, size=3)) @ p["T_gt"] for _ in range(K)]
        Rs.append(np.stack([T[:3, :3] for T in Tk]))
        ts.append(np.stack([T[:3, 3] for T in Tk]))
    R = np.stack(Rs).astype(np.float32)                          # [2, K, 3, 3]
    t = np.stack(ts).astype(np.float32)
    mask = np.ones((2, N), np.float32)
    mask[0, 250:] = 0
    return dict(P=np.stack([p["P"] for p in probs]), Q=np.stack([p["Q"] for p in probs]),
                triples=triples, r9=R.reshape(2, K, 9).transpose(0, 2, 1).copy(),
                t3=t.transpose(0, 2, 1).copy(), R=R, t=t, mask=mask)


def _t(case, *keys):
    return [torch.from_numpy(case[k]) for k in keys]


def test_solve3_matches_pallas(case):
    r9, t3 = ksolve.solve3(*_t(case, "P", "Q", "triples"))
    assert r9.shape == (2, 9, K) and t3.shape == (2, 3, K)
    for b in range(2):
        ref_r, ref_t = solve3_pallas_soa(jnp.asarray(case["P"][b]), jnp.asarray(case["Q"][b]),
                                         jnp.asarray(case["triples"][b], jnp.int32))
        np.testing.assert_allclose(r9[b].numpy(), np.asarray(ref_r), atol=1e-5)
        np.testing.assert_allclose(t3[b].numpy(), np.asarray(ref_t), atol=1e-5)
    det = np.linalg.det(r9.permute(0, 2, 1).reshape(2, K, 3, 3).double().numpy())
    np.testing.assert_allclose(det, 1.0, atol=1e-4)


def test_weighted_umeyama_matches_jax_and_oracle():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(16, 40, 3)).astype(np.float32)
    T = np.stack([se3np.random_transform(rng) for _ in range(16)])
    q = (se3np.apply_T(T, p.astype(np.float64))
         + rng.normal(scale=1e-3, size=p.shape)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(16, 40)).astype(np.float32)
    w[:, ::3] = 0.0
    R, t = umeyama(torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(w))
    Rj, tj = jumeyama(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
    for b in range(4):
        Rn, tn = oracle.umeyama(p[b], q[b], w[b])
        np.testing.assert_allclose(R[b].numpy(), Rn, atol=2e-3)
        np.testing.assert_allclose(t[b].numpy(), tn, atol=2e-3)
    T4 = transform_from_rt(R, t)
    np.testing.assert_array_equal(T4[:, 3].numpy(), np.tile([0, 0, 0, 1.0], (16, 1)))


@pytest.mark.parametrize("mode", ["count", "weighted"])
def test_score_matches_pallas(case, mode):
    r9, t3, P, Q, m = _t(case, "r9", "t3", "P", "Q", "mask")
    scores, counts = kscore.score_hypotheses(r9, t3, P, Q, TAU, mask=m, mode=mode)
    assert counts.dtype == torch.int32 and counts.max() > 50
    for b in range(2):
        ref_s, ref_c = score_hypotheses_pallas_soa(
            jnp.asarray(case["r9"][b]), jnp.asarray(case["t3"][b]), jnp.asarray(case["P"][b]),
            jnp.asarray(case["Q"][b]), TAU, mask=jnp.asarray(case["mask"][b]), mode=mode)
        np.testing.assert_array_equal(counts[b].numpy(), np.asarray(ref_c))
        np.testing.assert_allclose(scores[b].numpy(), np.asarray(ref_s), rtol=1e-4, atol=1e-4)


def test_inlier_mask_matches_jax(case):
    R, t, P, Q, m = _t(case, "R", "t", "P", "Q", "mask")
    got = tscore.inlier_mask(R[:, 0], t[:, 0], P, Q, TAU, mask=m).numpy()
    assert got.sum() > 50
    for b in range(2):
        ref = jscore.inlier_mask(jnp.asarray(case["R"][b, 0]), jnp.asarray(case["t"][b, 0]),
                                 jnp.asarray(case["P"][b]), jnp.asarray(case["Q"][b]), TAU,
                                 mask=jnp.asarray(case["mask"][b]))
        np.testing.assert_array_equal(got[b], np.asarray(ref))
    assert not got[0, 250:].any()


@needs_cuda
def test_solve3_kernel_matches_plain_on_card(case):
    P, Q, tri = (x.cuda() for x in _t(case, "P", "Q", "triples"))
    got = ksolve.solve3(P, Q, tri)
    ref = ksolve.solve3_reference(P, Q, tri)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@needs_cuda
@pytest.mark.parametrize("mode", ["count", "weighted"])
def test_score_kernel_matches_plain_on_card(case, mode):
    args = [x.cuda() for x in _t(case, "r9", "t3", "P", "Q")]
    m = torch.from_numpy(case["mask"]).cuda()
    s, c = kscore.score_hypotheses(*args, TAU, mask=m, mode=mode)
    rs, rc = kscore.score_hypotheses_reference(*args, TAU, mask=m, mode=mode)
    # Every residual operation is rounded on its own on both sides: identical.
    assert torch.equal(c, rc)
    if mode == "weighted":
        torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-3)
