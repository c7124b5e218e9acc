"""PyTorch port vs the JAX package: the distributed estimator.

The port runs in spawned gloo ranks (`saccot_tpu_torch.dist.local.run_ranks`,
rank bodies in tests/torch_dist_ranks.py) on CPU tensors, so every kernel
wrapper takes its plain version. The JAX side runs in this process on the 8
faked CPU devices of tests/conftest.py, with its four stages on Pallas in
interpret mode, as tests/test_dist.py runs the ring kernel. Both get the
same NumPy inputs; the bounds are those of tests/test_dist.py. The ring-step
and direct-degree kernels need a card and skip here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_ranks
from saccot_tpu.dist.mesh import make_mesh
from saccot_tpu.dist.ring import degrees_ring as jdegrees_ring
from saccot_tpu.dist.sweep import make_sweep_fn
from saccot_tpu.engine.sac_cot import (
    RegistrationResult, register_pair, register_pair_sp, register_pair_tp,
)
from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.kernels.compat import degrees_pallas
from saccot_tpu.utils import se3np
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch.dist.local import run_ranks
from saccot_tpu_torch.engine import triangles as ttri
from saccot_tpu_torch.engine.sac_cot import register_batch
from saccot_tpu_torch.evaluation.metrics import registration_recall
from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import ring_compat as kring
from saccot_tpu_torch.utils.convert import (
    KITTI_CRITERION, KITTI_PARAMS, KITTI_SEED, kitti_problem_batch, problem_batch,
)
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
N = 128
B = 8
PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=48, neighbors_per_anchor=10, max_hypotheses=256,
    degree_block_rows=64,
)
RING = dataclasses.replace(PARAMS, ring_compat=True)
FAST = dataclasses.replace(PARAMS, dedup_triangles=False, per_anchor_candidates=4,
                           max_hypotheses=192)
PALLAS = dict(compat_impl="pallas", score_impl="pallas", pool_impl="pallas", solve_impl="pallas")


def _jax(params):
    """The JAX package's SacCotParams with the same field values."""
    return JaxSacCotParams(**dataclasses.asdict(params))


def _problem(seed, pad=0, masked_tail=0, outlier_ratio=0.5):
    """(P, Q, mask) of one planted problem of N correspondences: the last
    `pad` rows are zero padding, the last `pad + masked_tail` masked out."""
    prob = correspondence_problem(seed=seed, n=N - pad, outlier_ratio=outlier_ratio)
    Pn = np.concatenate([prob["P"], np.zeros((pad, 3), np.float32)])
    Qn = np.concatenate([prob["Q"], np.zeros((pad, 3), np.float32)])
    mask = np.ones((N,), np.float32)
    mask[N - pad - masked_tail:] = 0.0
    return Pn, Qn, mask


@pytest.fixture(scope="module")
def probs():
    return {
        "deg": _problem(301, masked_tail=17),   # the mask crosses shard bounds
        "allgather": _problem(200),
        "ring": _problem(302),
        "masked": _problem(201, pad=32, outlier_ratio=0.4),
        "anchor": _problem(321),
        "tp": _problem(400),
    }


@pytest.fixture(scope="module")
def sweep_batch():
    pr = [correspondence_problem(seed=100 + s, n=N, outlier_ratio=0.5) for s in range(B)]
    return (np.stack([p["P"] for p in pr]), np.stack([p["Q"] for p in pr]),
            np.stack([p["T_gt"] for p in pr]))


@pytest.fixture(scope="module")
def world2(probs):
    """Every two-rank case, in one spawn of two gloo ranks, which join by
    `init_distributed`'s explicit arguments with the rank variables unset."""
    return run_ranks(torch_dist_ranks.world2, 2, "gloo", probs, PARAMS, RING, FAST,
                     timeout=300, explicit_init=True)


@pytest.fixture(scope="module")
def world4(probs, sweep_batch):
    return run_ranks(torch_dist_ranks.world4, 4, "gloo", probs["deg"], *sweep_batch[:2],
                     PARAMS, timeout=300)


def _shard_map(fn, mesh, in_spec, out_specs, *arrays):
    sm = jax.shard_map(fn, mesh=mesh, in_specs=(in_spec,) * len(arrays), out_specs=out_specs,
                       check_vma=False)
    return jax.jit(sm)(*(jnp.asarray(a) for a in arrays))


def _specs(inliers):
    return RegistrationResult(R=P(), t=P(), T=P(), inliers=inliers, num_inliers=P(),
                              best_score=P(), num_valid_triangles=P(), success=P())


def _rot_deg(T_a, T_b):
    E = np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64))
    return float(se3np.rotation_angle_deg(E[:3, :3]))


# -- degrees over the ring -------------------------------------------------------

@pytest.mark.parametrize("corr", [2, 4])
def test_ring_degrees_match_pallas_ring(probs, world2, world4, corr):
    """`degrees_ring` (plain steps, gloo hops) vs the fused Pallas ring kernel
    under shard_map, rtol 1e-5 / atol 1e-3 (`kernels/ring_compat.py:31-36`:
    direct differences against the Gram trick, and summation order)."""
    ranks = world2 if corr == 2 else world4
    got = np.concatenate([r["ring_deg"][0] for r in ranks])
    ref = _shard_map(
        lambda p, q, m: jdegrees_ring(p, q, _jax(PARAMS), "corr", mask_loc=m, impl="pallas"),
        make_mesh(pairs=1, corr=corr), P("corr"), P("corr"), *probs["deg"])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("d", [2, 4])
def test_ring_steps_sum_to_direct_degrees(probs, d):
    """`ring_degrees_step_reference` over every column block, in ring order,
    vs `degrees_pallas(mxu=False)` (the direct-form kernel, interpret mode),
    same tolerance; the port's `degrees(mxu=False)` takes its plain version
    on the CPU and agrees as well."""
    Pn, Qn, mask = probs["deg"]
    n = N // d
    blocks = [kring.pack_block(*(torch.from_numpy(x[r * n:(r + 1) * n])[None]
                                 for x in (Pn, Qn, mask))) for r in range(d)]
    got = []
    for r in range(d):
        deg = torch.zeros((1, n))
        for s in range(d):
            src = (r - s) % d
            kring.ring_degrees_step(blocks[r], blocks[src], deg, r * n, src * n, PARAMS)
        got.append(deg[0].numpy())
    got = np.concatenate(got)
    jm = jnp.asarray(mask)
    ref = np.asarray(degrees_pallas(jnp.asarray(Pn), jnp.asarray(Qn), jnp.asarray(Pn),
                                    jnp.asarray(Qn), _jax(PARAMS), mask_rows=jm, mask_cols=jm,
                                    mxu=False))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    t = [torch.from_numpy(x)[None] for x in (Pn, Qn, mask)]
    direct = kcompat.degrees(t[0], t[1], t[0], t[1], PARAMS, mask_rows=t[2], mask_cols=t[2],
                             mxu=False)
    np.testing.assert_allclose(direct[0].numpy(), ref, rtol=1e-5, atol=1e-3)


# -- the sharded estimator -----------------------------------------------------

@pytest.mark.parametrize("case", ["allgather", "ring", "masked"])
def test_register_batch_sp_matches_register_pair_sp(probs, world2, case):
    """SP over two ranks vs `register_pair_sp` under shard_map (corr = 2):
    rotation < 0.05 deg, equal num_inliers, equal local inliers (the padded
    tail never an inlier), as tests/test_dist.py:80-130."""
    params = RING if case == "ring" else PARAMS
    ref = _shard_map(
        lambda p, q, m: register_pair_sp(p, q, _jax(params), "corr", mask_shard=m, **PALLAS),
        make_mesh(pairs=1, corr=2), P("corr"), _specs(P("corr")), *probs[case])
    for r, res in enumerate(world2):
        got = res[case]
        assert _rot_deg(got.T[0], ref.T) < 0.05
        assert int(got.num_inliers[0]) == int(ref.num_inliers)
        np.testing.assert_array_equal(got.inliers[0],
                                      np.asarray(ref.inliers)[r * N // 2:(r + 1) * N // 2])
    if case == "masked":
        assert not world2[1]["masked"].inliers[0][-32:].any()


def test_sp_records_the_valid_counts_of_the_local_shard(probs, world2):
    """A masked SP call keeps the valid count of this rank's shard, marked local."""
    mask = probs["masked"][2]
    for r, res in enumerate(world2):
        counts, local = res["masked_counts"]
        assert local is True
        assert counts.tolist() == [int(mask[r * N // 2:(r + 1) * N // 2].sum())]


def test_register_batch_tp_matches_register_pair_tp(probs, world2):
    """TP over two ranks vs `register_pair_tp` (hyp = 2): the same
    registration, num_inliers, best score and inliers
    (tests/test_dist.py:249-275)."""
    mesh = make_mesh(pairs=1, corr=1, hyp=2)
    ref = _shard_map(lambda p, q, m: register_pair_tp(p, q, _jax(PARAMS), "hyp", mask=m, **PALLAS),
                     mesh, P(), _specs(P()), *probs["tp"])
    for res in world2:
        got = res["tp"]
        assert _rot_deg(got.T[0], ref.T) < 0.05
        assert int(got.num_inliers[0]) == int(ref.num_inliers)
        assert float(got.best_score[0]) == float(ref.best_score)
        np.testing.assert_array_equal(got.inliers[0], np.asarray(ref.inliers))


@pytest.mark.parametrize("case", ["allgather", "ring", "masked", "anchor"])
def test_register_pair_sp_matches_jax_and_the_batch_form(probs, world2, case):
    """`register_pair_sp` over two ranks vs the JAX package's under
    shard_map (corr = 2), with the batch form's bounds, and bit for bit the
    row of `register_batch_sp` for the same pair."""
    params = {"ring": RING, "anchor": FAST}.get(case, PARAMS)
    ref = _shard_map(
        lambda p, q, m: register_pair_sp(p, q, _jax(params), "corr", mask_shard=m, **PALLAS),
        make_mesh(pairs=1, corr=2), P("corr"), _specs(P("corr")), *probs[case])
    for r, res in enumerate(world2):
        got = res["pair_" + case]
        for a, b in zip(got, res[case]):
            np.testing.assert_array_equal(a, b[0])
        assert _rot_deg(got.T, ref.T) < 0.05
        assert int(got.num_inliers) == int(ref.num_inliers)
        np.testing.assert_array_equal(got.inliers,
                                      np.asarray(ref.inliers)[r * N // 2:(r + 1) * N // 2])


def test_register_pair_tp_matches_jax_and_the_batch_form(probs, world2):
    """`register_pair_tp` over two ranks vs the JAX package's (hyp = 2),
    with the batch form's bounds, and bit for bit `register_batch_tp`'s row."""
    ref = _shard_map(lambda p, q, m: register_pair_tp(p, q, _jax(PARAMS), "hyp", mask=m, **PALLAS),
                     make_mesh(pairs=1, corr=1, hyp=2), P(), _specs(P()), *probs["tp"])
    for res in world2:
        got = res["pair_tp"]
        for a, b in zip(got, res["tp"]):
            np.testing.assert_array_equal(a, b[0])
        assert _rot_deg(got.T, ref.T) < 0.05
        assert int(got.num_inliers) == int(ref.num_inliers)
        assert float(got.best_score) == float(ref.best_score)
        np.testing.assert_array_equal(got.inliers, np.asarray(ref.inliers))


def test_explicit_init_joins_two_ranks_without_the_rank_variables(world2):
    """The two ranks of `world2` joined by `init_distributed(address, 2, r)`
    with MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE unset."""
    assert [res["init"] for res in world2] == [
        dict(rank=r, world=2, backend="gloo", env=[]) for r in range(2)]


def test_sweep_dp_x_sp_matches_make_sweep_fn(sweep_batch, world4):
    """The (pairs=2, corr=2) sweep over four ranks vs `make_sweep_fn` on the
    same mesh shape, with `_check_equal`'s bounds (tests/test_dist.py:40-77):
    < 0.2 deg and 5e-3 apart, < 3 deg from the truth, inliers within 1."""
    P_all, Q_all, T_gt = sweep_batch
    sweep = make_sweep_fn(make_mesh(pairs=2, corr=2), _jax(PARAMS), **PALLAS)
    ref = sweep(jnp.asarray(P_all), jnp.asarray(Q_all), jnp.ones((B, N), jnp.float32))
    for res in world4:
        got = res["sweep"]
        assert got.T.shape == (B, 4, 4) and got.inliers.shape == (B, N)
        for b in range(B):
            E = got.T[b].astype(np.float64) @ np.linalg.inv(np.asarray(ref.T[b], np.float64))
            assert se3np.rotation_angle_deg(E[:3, :3]) < 0.2
            assert np.linalg.norm(E[:3, 3]) < 5e-3
            assert _rot_deg(got.T[b], T_gt[b]) < 3.0
        diff = got.num_inliers.astype(np.int64) - np.asarray(ref.num_inliers, np.int64)
        assert np.abs(diff).max() <= 1


def test_anchor_sharded_pool_matches_single_device(probs, world2):
    """Fast config under SP: each rank scores A/2 anchors, the all-gather in
    rank order rebuilds the unsharded pool exactly, and the registration
    matches the JAX package's single-device one (tests/test_dist.py:308-339)."""
    Pn, Qn, mask = probs["anchor"]
    Pt, Qt = torch.from_numpy(Pn)[None], torch.from_numpy(Qn)[None]
    deg = kcompat.degrees(Pt, Qt, Pt, Qt, FAST)
    whole = ttri.triangle_pool_from_points(Pt, Qt, deg, FAST)
    assert whole.valid.sum() > 50
    ref = register_pair(jnp.asarray(Pn), jnp.asarray(Qn), _jax(FAST), **PALLAS)
    for r, res in enumerate(world2):
        for got, want in zip(res["pool"], whole):
            np.testing.assert_array_equal(got, want.numpy())
        got = res["anchor"]
        assert _rot_deg(got.T[0], ref.T) < 0.05
        assert int(got.num_inliers[0]) == int(ref.num_inliers)
        np.testing.assert_array_equal(got.inliers[0],
                                      np.asarray(ref.inliers)[r * N // 2:(r + 1) * N // 2])


# -- the kernels on the card -------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("d", [2, 4])
def test_ring_step_kernel_matches_plain_on_card(probs, d):
    """`csrc/ring_degrees.cu` vs its plain version over every block pair,
    rtol 1e-5 / atol 1e-3; two calls give the same bits."""
    Pn, Qn, mask = (torch.from_numpy(x).cuda() for x in probs["deg"])
    n = N // d
    blocks = [kring.pack_block(Pn[None, r * n:(r + 1) * n], Qn[None, r * n:(r + 1) * n],
                               mask[None, r * n:(r + 1) * n]) for r in range(d)]
    before = _build.launches()["ring_degrees"]
    for r in range(d):
        for c in range(d):
            got = kring.ring_degrees_step(blocks[r], blocks[c], torch.zeros((1, n), device="cuda"),
                                          r * n, c * n, PARAMS)
            again = kring.ring_degrees_step(blocks[r], blocks[c],
                                            torch.zeros((1, n), device="cuda"), r * n, c * n,
                                            PARAMS)
            ref = kring.ring_degrees_step_reference(blocks[r], blocks[c],
                                                    torch.zeros((1, n), device="cuda"),
                                                    r * n, c * n, PARAMS)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
            assert torch.equal(got, again)
    assert _build.launches()["ring_degrees"] == before + 2 * d * d


@needs_cuda
def test_direct_degrees_kernel_matches_plain_on_card(probs):
    """`degrees(mxu=False)` launches the two-sided kernel under its own
    counter, even where the symmetric route would be taken."""
    Pn, Qn, mask = (torch.from_numpy(x).cuda()[None] for x in probs["deg"])
    before = _build.launches()
    got = kcompat.degrees(Pn, Qn, Pn, Qn, PARAMS, mask_rows=mask, mask_cols=mask, mxu=False)
    after = _build.launches()
    assert after["compat_degrees_direct"] == before["compat_degrees_direct"] + 1
    assert after["compat_degrees"] == before["compat_degrees"]
    ref = kcompat.degrees_reference(Pn, Qn, Pn, Qn, PARAMS, mask_rows=mask, mask_cols=mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)


@needs_cuda
def test_distributed_over_nccl_on_two_cards():
    """With two cards, two NCCL ranks (a card each) run SP with the ring at
    the kitti configuration (recall 1, within 0.1 deg of one rank, two ring
    steps per rank), TP (bit-identical to one rank) and DP (inliers within 1,
    within 0.05 deg) at 32 bench-point pairs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL gives each rank a card of its own")
    bench = dataclasses.replace(PARAMS, num_anchors=256, neighbors_per_anchor=12,
                                max_hypotheses=1024, dedup_triangles=False,
                                per_anchor_candidates=4)
    ranks = run_ranks(torch_dist_ranks.cards, 2, "nccl", KITTI_PARAMS, bench, timeout=600)
    assert {r["backend"] for r in ranks} == {"nccl"}
    assert sorted(r["device"] for r in ranks) == [0, 1]
    P, Q, T_gt = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device="cuda")
    one = register_batch(P, Q, KITTI_PARAMS)
    Pb, Qb, _ = problem_batch(range(1000, 1032), device="cuda", n=1000, outlier_ratio=0.8,
                              noise=0.004)
    one_b = register_batch(Pb, Qb, bench)
    T1, Tb = one.T.cpu().numpy(), one_b.T.cpu().numpy()
    for r in ranks:
        sp = r["sp_ring"]
        assert registration_recall(zip(sp.T, T_gt), *KITTI_CRITERION) == 1.0
        assert max(_rot_deg(sp.T[b], T1[b]) for b in range(2)) < 0.1
        assert r["launches"]["ring_degrees"] == 2
        np.testing.assert_array_equal(r["tp"].T, Tb)
        assert np.abs(r["dp"].num_inliers - one_b.num_inliers.cpu().numpy()).max() <= 1
        assert max(_rot_deg(r["dp"].T[b], Tb[b]) for b in range(32)) < 0.05
