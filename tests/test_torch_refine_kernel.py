"""The refine kernel (`csrc/refine.cu`, `kernels/refine.py`).

On the CPU: its launch plan, the wrapper's checks of its inputs, the plan
against the kernel's source, and the routes (CPU tensors and
`impl="plain"` take the plain refine, bit for bit, and launch nothing). On
the card (skipped here: a CUDA kernel has no CPU mode): the kernel against
the plain refine at the 3DMatch and kitti shapes, with and without a mask;
a pair with fewer than 3 inliers and an all-masked pair keep their fit; a
pair's bits do not depend on its batch, through the whole estimator too.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from saccot_tpu_torch.engine import sac_cot
from saccot_tpu_torch.engine import score as score_mod
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import refine as krefine
from saccot_tpu_torch.utils.convert import (
    KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch,
)
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
CSRC = Path(krefine.__file__).resolve().parent.parent / "csrc"
TDM_PARAMS = SacCotParams(compat_tau=0.05, inlier_tau=0.05, min_separation=0.1,
                          max_hypotheses=2048)


def _csrc_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / "refine.cu").read_text())
    assert m, f"{name} not found in refine.cu"
    return int(m.group(1))


# -- refine_plan ------------------------------------------------------------------

@pytest.mark.parametrize("batch,N", [(1, 1), (1, 256), (1, 257), (32, 2048), (64, 50000),
                                     (1623, 2048), (3, 4999), (krefine.MAX_BATCH, 7)])
def test_refine_plan_covers_every_point_once(batch, N):
    plan = krefine.refine_plan(batch, N, 2)
    assert (plan.segments - 1) * krefine.SEGMENT < N <= plan.segments * krefine.SEGMENT
    assert (plan.batch, plan.iters, plan.sharded) == (batch, 2, False)


def test_refine_plan_at_the_cells():
    """kitti.sweep: 64 pairs of 196 segments; threedmatch.sweep: 1,623 of 8;
    5 launches a call at refine_iters = 2, 7 where the points are sharded."""
    kitti = krefine.refine_plan(64, 50000, 2)
    tdm = krefine.refine_plan(1623, 2048, 2)
    assert (kitti.segments, tdm.segments) == (196, 8)
    assert kitti.launches == tdm.launches == 5
    assert krefine.refine_plan(64, 25000, 2, sharded=True).launches == 7
    assert krefine.refine_plan(4, 10, 0).launches == 1


@pytest.mark.parametrize("batch,N,iters", [(0, 10, 2), (krefine.MAX_BATCH + 1, 10, 2),
                                           (2, 0, 2), (2, 10, -1)])
def test_refine_plan_refuses_what_the_kernel_cannot_run(batch, N, iters):
    with pytest.raises(ValueError):
        krefine.refine_plan(batch, N, iters)


def test_refine_plan_matches_the_kernel_source():
    src = (CSRC / "refine.cu").read_text()
    assert _csrc_int("kThreads") == krefine.SEGMENT
    assert _csrc_int("kSums") == krefine.SUMS and _csrc_int("kCov") == krefine.COV
    assert "enum Pass { kMomentsPass = 0, kCovPass = 1, kMaskPass = 2 };" in src
    assert (krefine.MOMENTS_PASS, krefine.COV_PASS, krefine.MASK_PASS) == (0, 1, 2)
    assert "dim3(segs, batch)" in src
    # One Horn iteration and one assembly of R and t, shared with the solve.
    assert src.count("saccot::quaternion_from_cross_covariance(h, q);") == 1
    assert src.count("saccot::rigid_from_quaternion(") == 1
    assert "saccot::rigid_from_quaternion(qv, pbar, qbar, r, t);" in (
        CSRC / "solve3.cu").read_text()


# -- the wrapper's checks and routes on the CPU ------------------------------------

def _case(batch=3, N=300, seed=0, device="cpu"):
    """Points near a rigid motion (about half within 0.05), a fit near it,
    and a mask that drops every seventh point."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(-1, 1, size=(batch, N, 3)).astype(np.float32)
    Q = (P + rng.normal(scale=0.03, size=P.shape)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1))
    R += rng.normal(scale=0.002, size=R.shape).astype(np.float32)
    t = rng.normal(scale=0.005, size=(batch, 3)).astype(np.float32)
    m = np.ones((batch, N), np.float32)
    m[:, ::7] = 0
    return [torch.from_numpy(x).to(device) for x in (P, Q, R, t, m)]


PARAMS = SacCotParams(inlier_tau=0.05)


@pytest.mark.parametrize("what,shape", [("P", (3, 300, 2)), ("Q", (3, 299, 3)), ("R", (3, 9)),
                                        ("t", (2, 3)), ("m", (3, 300, 1))])
def test_refine_wrapper_refuses_inputs_of_another_shape(what, shape):
    """Shapes are checked before devices, so CPU tensors raise too."""
    args = dict(zip("PQRtm", _case()))
    args[what] = torch.zeros(shape)
    with pytest.raises(ValueError, match=f"{what} must"):
        krefine._refine(args["P"], args["Q"], args["R"], args["t"], PARAMS, args["m"])


def test_refine_wrapper_refuses_host_tensors_and_oversized_batches():
    P, Q, R, t, m = _case()
    with pytest.raises(ValueError, match="CUDA tensor"):
        krefine._refine(P, Q, R, t, PARAMS, m)
    b = krefine.MAX_BATCH + 1   # expanded: no storage
    with pytest.raises(ValueError, match="pairs a launch"):
        krefine._refine(P[:1].expand(b, -1, -1), Q[:1].expand(b, -1, -1),
                        R[:1].expand(b, -1, -1), t[:1].expand(b, -1), PARAMS,
                        m[:1].expand(b, -1))


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_cpu_tensors_take_the_plain_refine(iters):
    """On CPU tensors both routes are the plain refine, bit for bit, and no
    kernel is counted."""
    P, Q, R, t, m = _case()
    params = dataclasses.replace(PARAMS, refine_iters=iters)
    before = _build.launches()
    ref = krefine.refine_reference(P, Q, R, t, params, m)
    for got in (krefine.refine(P, Q, R, t, params, m),
                sac_cot.refine(P, Q, R, t, params, m),
                sac_cot.refine(P, Q, R, t, params, m, impl="plain")):
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
    assert _build.launches() == before
    assert ref[2].any() and not ref[2].all()
    assert torch.equal(ref[2], score_mod.inlier_mask(ref[0], ref[1], P, Q, PARAMS.inlier_tau,
                                                     mask=m))
    with pytest.raises(ValueError, match="impl"):
        sac_cot.refine(P, Q, R, t, params, m, impl="pallas")


# -- the kernel on the card ---------------------------------------------------------

def _near(T, tau, seed):
    """T [batch, 4, 4] float64 turned by 0.05 degree and moved by tau / 5,
    as (R, t) float32."""
    rng = np.random.default_rng(seed)
    R, t = [], []
    for Tb in T:
        k = rng.normal(size=3)
        k /= np.linalg.norm(k)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        a = np.deg2rad(0.05)
        dR = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K   # Rodrigues
        R.append(dR @ Tb[:3, :3])
        t.append(Tb[:3, 3] + 0.2 * tau * k)
    return np.asarray(R, np.float32), np.asarray(t, np.float32)


def _cell_case(cell, masked, device="cuda"):
    if cell == "kitti":
        P, Q, T = kitti_problem_batch(range(KITTI_SEED, KITTI_SEED + 4), device=device)
        params = KITTI_PARAMS
    else:
        P, Q, T = problem_batch(range(300, 332), device=device, n=2048, outlier_ratio=0.9,
                                noise=0.01)
        params = TDM_PARAMS
    R, t = (torch.from_numpy(x).to(device) for x in _near(T, params.inlier_tau, 1))
    m = torch.ones(P.shape[:2], dtype=torch.float32, device=device)
    if masked:
        m[:, ::5] = 0.0
        m[0, 1000:] = 0.0
    return P, Q, R, t, params, m


def _check_mask_flips(P, Q, got, ref, tau, m):
    """The kernel's mask is `inlier_mask` of its own fit, bit for bit; where
    it differs from the plain refine's, the point's residual under the plain
    fit lies within the two fits' distance at that point of tau."""
    Rk, tk, ik = got
    Rp, tp, ip = ref
    assert torch.equal(ik, score_mod.inlier_mask(Rk, tk, P, Q, tau, mask=m))
    flips = ik != ip
    if flips.any():
        x = score_mod._residual(Rp, tp, P, Q)
        d = torch.sqrt((x * x).sum(-1))
        reach = ((Rk - Rp).flatten(1).norm(dim=1)[:, None] * P.norm(dim=-1)
                 + (tk - tp).norm(dim=1)[:, None] + 1e-6 * tau)
        assert ((d - tau).abs() <= reach)[flips].all()


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cell", ["threedmatch", "kitti"])
def test_refine_kernel_matches_plain_on_card(cell, masked):
    """R and t within 1e-5 of the plain refine (the same sums in another
    order); one pass a launch, 2 refine_iters + 1 of them."""
    P, Q, R, t, params, m = _cell_case(cell, masked)
    before = _build.launches()["refine"]
    got = krefine.refine(P, Q, R, t, params, m)
    assert _build.launches()["refine"] == before + krefine.refine_plan(
        *P.shape[:2], params.refine_iters).launches
    ref = krefine.refine_reference(P, Q, R, t, params, m)
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=1e-5)
    _check_mask_flips(P, Q, got, ref, params.inlier_tau, m)
    assert got[2].sum(dim=1).min() >= 3
    again = krefine.refine(P, Q, R, t, params, m)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@needs_cuda
def test_refine_kernel_keeps_the_fit_of_pairs_without_three_inliers_on_card():
    """Pair 0 starts 100 away (no inlier), pair 1 has every point masked,
    pair 2 keeps two inliers: each keeps its fit and reports its inliers;
    pair 3 refines as it does alone."""
    P, Q, R, t, params, m = _cell_case("threedmatch", False)
    P, Q, R, t, m = (x[:4].clone() for x in (P, Q, R, t, m))
    t[0] += 100.0
    m[1] = 0.0
    d = score_mod.inlier_mask(R, t, P, Q, params.inlier_tau, mask=m)
    keep = torch.nonzero(d[2])[:2, 0]
    m[2] = 0.0
    m[2, keep] = 1.0
    Rk, tk, ik = krefine.refine(P, Q, R, t, params, m)
    for b in (0, 1, 2):
        assert torch.equal(Rk[b], R[b]) and torch.equal(tk[b], t[b])
    assert not ik[0].any() and not ik[1].any() and int(ik[2].sum()) == 2
    alone = krefine.refine(P[3:], Q[3:], R[3:], t[3:], params, m[3:])
    assert torch.equal(Rk[3], alone[0][0]) and torch.equal(tk[3], alone[1][0])
    assert not torch.equal(Rk[3], R[3])


@needs_cuda
@pytest.mark.parametrize("cell", ["threedmatch", "kitti"])
def test_refine_kernel_bits_independent_of_batch_on_card(cell):
    P, Q, R, t, params, m = _cell_case(cell, True)
    full = krefine.refine(P, Q, R, t, params, m)
    for b in (0, P.shape[0] - 1):
        one = krefine.refine(P[b:b + 1], Q[b:b + 1], R[b:b + 1], t[b:b + 1], params, m[b:b + 1])
        for x, y in zip(one, full):
            assert torch.equal(x[0], y[b])


@needs_cuda
def test_register_pair_at_kitti_equals_its_batch_row_on_card():
    """Every field of `register_pair` on a kitti pair equals that pair's
    row of a batch of 2, bit for bit: every kernel, the refine included,
    sums in an order fixed by N alone."""
    P, Q, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device="cuda")
    batch = sac_cot.register_batch(P, Q, KITTI_PARAMS)
    for b in range(2):
        pair = sac_cot.register_pair(P[b], Q[b], KITTI_PARAMS)
        for f in sac_cot.RegistrationResult._fields:
            assert torch.equal(getattr(pair, f), getattr(batch, f)[b]), f
