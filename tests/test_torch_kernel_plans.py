"""Launch plans of the score kernel, the fused anchor kernel, the two-sided
degree loop, the candidate top-T and the solve.

`score_plan` splits the point axis across blocks where the hypothesis tiles
alone would not fill the card; `anchor_plan` chooses how many anchors (one
warp each) a block of the fused anchor kernel holds; `degree_plan` chooses
the rows a thread of the two-sided degree loop (`compat_degrees.cu`,
`ring_degrees.cu`, `compat_ops.cu`) and splits its column segments;
`candidate_plan` chooses the anchors (one warp each) a block of the
candidate top-T holds; `solve_plan` the threads a block of the solve. All
are pure Python and are checked here. The kernels themselves are held to their
plain versions on the card (skipped here: a CUDA kernel has no CPU mode).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import ring_compat as kring
from saccot_tpu_torch.kernels import score as kscore
from saccot_tpu_torch.kernels import solve3 as ksolve
from saccot_tpu_torch.kernels import triangles as ktri
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
CSRC = Path(ktri.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132
TAU = 0.03

# (batch, K, N): the kitti point, the SP shard of it, the TP slice of the
# bench point, the bench and 3DMatch points, ragged and tiny shapes.
KITTI = (2, 2048, 50000)
SP_SHARD = (2, 2048, 25000)
TP_SLICE = (128, 512, 1000)
BENCH = (128, 1024, 1000)
SHAPES = [KITTI, SP_SHARD, TP_SLICE, BENCH, (32, 2048, 2048), (2, 300, 4999), (2, 300, 100),
          (1, 1, 1), (3, 257, 511), (1, 2048, 256), (2, 2048, 0)]


def _csrc_int(name: str, source: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


# -- score_plan -----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_score_splits_cover_every_point_once(shape):
    batch, K, N = shape
    plan = kscore.score_plan(batch, K, N, H100_SMS)
    assert plan.tiles * kscore.HYP_TILE >= K > (plan.tiles - 1) * kscore.HYP_TILE or K == 0
    assert plan.splits == 1 or plan.chunk % kscore.SEGMENT == 0
    covered = np.zeros(N, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.chunk, min(N, (s + 1) * plan.chunk)
        assert lo < hi or N == 0, f"split {s} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert plan.blocks == plan.tiles * plan.splits * batch


def test_score_plan_ragged_and_small():
    ragged = kscore.score_plan(2, 300, 4999, H100_SMS)
    assert ragged.splits > 1 and ragged.splits * ragged.chunk > 4999
    assert kscore.score_plan(2, 300, 100, H100_SMS).splits == 1   # N below one split's minimum


@pytest.mark.parametrize("shape", [KITTI, SP_SHARD, TP_SLICE], ids=["kitti", "sp_shard", "tp"])
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_score_plan_reaches_block_target(shape, sms):
    plan = kscore.score_plan(*shape, sms)
    assert plan.splits > 1
    assert plan.blocks >= kscore.SPLIT_BLOCKS_PER_SM * sms
    # The largest chunk of whole segments that does so.
    assert plan.chunk % kscore.SEGMENT == 0
    wider = kscore.ScorePlan(plan.batch, plan.tiles, -(-shape[2] // (plan.chunk + kscore.SEGMENT)),
                             plan.chunk + kscore.SEGMENT)
    assert wider.blocks < kscore.SPLIT_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("shape", [BENCH, (128, 2048, 1000), (64, 2048, 50000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_score_plan_keeps_one_split_when_the_grid_fills_the_card(shape):
    batch, K, N = shape
    plan = kscore.score_plan(batch, K, N, H100_SMS)
    assert plan.tiles * batch >= kscore.FULL_BLOCKS_PER_SM * H100_SMS
    assert plan.splits == 1 and plan.chunk == N


def test_score_plan_matches_the_kernel_source():
    assert _csrc_int("kThreads", "score.cu") == kscore.THREADS
    assert _csrc_int("kHyp", "score.cu") == kscore.HYP_PER_THREAD
    assert _csrc_int("kPointTile", "score.cu") == kscore.SEGMENT


# -- anchor_plan ------------------------------------------------------------------

@pytest.mark.parametrize("B", range(1, ktri.MAX_NEIGHBORS + 1))
def test_anchor_plan_fits_shared_memory(B):
    for N in range(B, ktri.MAX_N_FUSED + 1):
        plan = ktri.anchor_plan(N, B)
        per_warp = 4 * (ktri.WARP_SCRATCH_WORDS + max(N, B * B))
        assert 1 <= plan.warps <= ktri.MAX_WARPS
        assert plan.smem_bytes == plan.warps * per_warp
        # Within the 48 KB a block gets without an opt-in (so within the
        # H100's 227 KB a block).
        assert plan.smem_bytes <= ktri.ANCHOR_SMEM_BUDGET == 48 * 1024


def test_anchor_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):
        ktri.anchor_plan(ktri.MAX_N_FUSED + 1, 12)
    with pytest.raises(ValueError):
        ktri.anchor_plan(1000, ktri.MAX_NEIGHBORS + 1)
    with pytest.raises(ValueError):
        ktri.anchor_plan(8, 12)   # B > N
    assert ktri.anchor_plan(1000, 12).warps == ktri.MAX_WARPS   # the bench point


def test_anchor_plan_matches_the_kernel_source():
    assert _csrc_int("kMaxWarps", "anchor_topb.cu") == ktri.MAX_WARPS
    assert _csrc_int("kMaxB", "anchor_topb.cu") == ktri.MAX_NEIGHBORS
    # WarpScratch: sel_s, sel_i (kMaxB each) and sp, sq (3 kMaxB each).
    assert ktri.WARP_SCRATCH_WORDS == 8 * ktri.MAX_NEIGHBORS


# -- candidate_plan -----------------------------------------------------------------

# (batch, A): the kitti point, its anchor shard, the bench point's anchors,
# ragged and tiny shapes.
CANDIDATE_SHAPES = [(2, 512), (2, 256), (128, 256), (3, 41), (1, 1), (2, 0)]


@pytest.mark.parametrize("shape", CANDIDATE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("B", [1, 12, 16, 32])
def test_candidate_plan_covers_every_anchor_once(shape, B):
    batch, A = shape
    plan = ktri.candidate_plan(batch, A, B)
    assert 1 <= plan.warps <= ktri.MAX_WARPS
    assert plan.tiles * plan.warps >= A > (plan.tiles - 1) * plan.warps or A == 0
    assert plan.blocks == plan.tiles * batch
    # Each warp's region: selections (8 B words) and the B x B grid, within
    # the 48 KB a block gets without an opt-in.
    assert plan.smem_bytes == 4 * plan.warps * (8 * B + B * B)
    assert plan.smem_bytes <= ktri.ANCHOR_SMEM_BUDGET
    assert plan == ktri.make_candidate_plan(batch, A, B, plan.warps)


def test_candidate_plan_refuses_what_the_kernel_cannot_hold():
    for B in (0, ktri.MAX_NEIGHBORS + 1):
        with pytest.raises(ValueError):
            ktri.candidate_plan(2, 512, B)
    # The widest plan of the sweep at the widest B still fits 48 KB.
    widest = ktri.make_candidate_plan(2, 512, ktri.MAX_NEIGHBORS, ktri.MAX_WARPS)
    assert widest.smem_bytes == 40 * 1024 <= ktri.ANCHOR_SMEM_BUDGET


def test_candidate_plan_matches_the_kernel_source():
    src = (CSRC / "candidate_topt.cu").read_text()
    assert _csrc_int("kMaxWarps", "candidate_topt.cu") == ktri.MAX_WARPS
    assert _csrc_int("kMaxB", "candidate_topt.cu") == ktri.MAX_NEIGHBORS
    assert "return 8 * B + B * B;" in src
    # One warp an anchor: no block barrier, the helpers at warp scope.
    assert "__syncthreads" not in src and "saccot::WarpScope scope{}" in src


# -- solve_plan ---------------------------------------------------------------------

# (batch, K): the kitti point, the 3DMatch point, the bench point, a TP rank's
# share of the bench point, the slam configuration (13 edges of K=512), ragged
# and tiny shapes, K below a block.
SOLVE_SHAPES = [(2, 2048), (32, 2048), (128, 1024), (128, 512), (13, 512), (3, 257), (1, 1),
                (2, 0), (1, 5000), (1, 100), (7, 33)]


@pytest.mark.parametrize("shape", SOLVE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_solve_plan_covers_every_hypothesis_once(shape, sms):
    """`solve_plan` covers every hypothesis once, a thread each, in the
    largest blocks of THREADS and MID_THREADS that cover the SMs, else of
    FEW_THREADS."""
    batch, K = shape
    plan = ksolve.solve_plan(batch, K, sms)
    assert plan.threads in (ksolve.THREADS, ksolve.MID_THREADS, ksolve.FEW_THREADS)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= ksolve.MAX_THREADS
    assert plan.tiles * plan.threads >= K > (plan.tiles - 1) * plan.threads or K == 0
    assert plan.blocks == plan.tiles * batch
    assert plan == ksolve.make_solve_plan(batch, K, plan.threads)
    covers = [t for t in (ksolve.THREADS, ksolve.MID_THREADS)
              if ksolve.make_solve_plan(batch, K, t).blocks >= sms]
    assert plan.threads == (covers[0] if covers else ksolve.FEW_THREADS)


@pytest.mark.parametrize("shape", [(16, 2048), (32, 1024), (64, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_solve_plan_keeps_blocks_of_128_where_they_cover_the_sms(shape):
    """Where blocks of 256 would be fewer than the SMs and blocks of 128
    cover them, the plan keeps row 3's blocks of 128."""
    assert ksolve.make_solve_plan(*shape, ksolve.THREADS).blocks < H100_SMS
    plan = ksolve.solve_plan(*shape, H100_SMS)
    assert plan.threads == ksolve.MID_THREADS == 128
    assert plan.blocks >= H100_SMS


def test_solve_plan_at_few_hypotheses():
    """Where blocks of 128 would be fewer than the SMs (the kitti point's
    2 x 2,048 hypotheses make 32), the plan takes blocks of FEW_THREADS; so
    does the slam configuration (13 x 512)."""
    assert ksolve.make_solve_plan(2, 2048, ksolve.MID_THREADS).blocks == 32
    plan = ksolve.solve_plan(2, 2048, H100_SMS)
    assert plan.threads == ksolve.FEW_THREADS == 64 and plan.blocks == 64
    assert ksolve.solve_plan(13, 512, H100_SMS).threads == ksolve.FEW_THREADS


@pytest.mark.parametrize("shape", [(128, 1024), (32, 2048), (128, 512)],
                         ids=["bench", "3dmatch", "tp_slice"])
def test_solve_plan_takes_blocks_of_256_where_they_cover_the_sms(shape):
    """The bench and 3DMatch points, and a TP rank's half of the bench
    point, take blocks of 256: at the first two they were lower than blocks
    of 128."""
    plan = ksolve.solve_plan(*shape, H100_SMS)
    assert plan.threads == ksolve.THREADS == 256
    assert plan.blocks >= H100_SMS


def test_solve_plan_matches_the_kernel_source():
    src = (CSRC / "solve3.cu").read_text()
    assert _csrc_int("kMaxThreads", "solve3.cu") == ksolve.MAX_THREADS
    assert "solve3_kernel<<<grid, threads," in src
    # The kernel runs the one fit, and the fit runs horn.cuh's quaternion.
    assert src.count("fit3(p, q, r, t);") == 1
    assert "saccot::quaternion_from_cross_covariance(h, qv);" in src
    horn = (CSRC / "horn.cuh").read_text()
    assert "void quaternion_from_cross_covariance(const float h[9], float q[4])" in horn
    assert horn.count("power_step(A);") == 8


def test_solve_wrapper_refuses_plans_of_another_shape():
    """`_solve` raises on a plan that is no grid of the shape, and on a
    cloud whose row offsets outgrow the kernel's 32-bit indices, before any
    launch (so here, on CPU tensors, too)."""
    P = torch.zeros(2, 10, 3)
    tri = torch.zeros(2, 300, 3, dtype=torch.int64)
    for plan in (ksolve.make_solve_plan(2, 400, 128),
                 ksolve.make_solve_plan(3, 300, 128),
                 ksolve.make_solve_plan(2, 300, 512),
                 ksolve.make_solve_plan(2, 300, 100),
                 dataclasses.replace(ksolve.make_solve_plan(2, 300, 64), tiles=4)):
        with pytest.raises(ValueError, match="no grid"):
            ksolve._solve(P, P, tri, plan)
    big = torch.zeros(1, 1, 3).expand(1, 2 ** 30, 3)     # 3 N > 2^31, no storage
    with pytest.raises(ValueError, match="32-bit"):
        ksolve._solve(big, big, tri[:1], ksolve.make_solve_plan(1, 300, 128))


def test_small_kernel_sweep_names_grids_the_kernels_run():
    """`scripts/exp_small_kernels.py` sweeps W for the candidate top-T and
    the threads a block for the solve; each is a grid its launcher accepts,
    and the plans the wrappers choose at the swept shapes are among them."""
    from saccot_tpu_torch.scripts import exp_small_kernels as xsmall

    for A in (512, 256):
        plans = xsmall.candidate_plans(2, A, 16)
        assert {p.warps for p in plans} == {1, 2, 4, 8}
        assert ktri.candidate_plan(2, A, 16) in plans
    for batch, K in ((2, 2048), (32, 2048), (128, 1024)):
        plans = xsmall.solve_plans(batch, K)
        assert {p.threads for p in plans} == {32, 64, 128, 256}
        assert ksolve.solve_plan(batch, K, H100_SMS) in plans


def test_launch_floor_kernel_is_counted_as_the_ports():
    """The empty kernel is one of the port's own kernel names, so
    `kernel_device_ms` reads it as it reads the others."""
    from saccot_tpu_torch.utils.profile import own_kernel_names

    names = own_kernel_names()
    assert "empty_kernel" in names
    assert {"candidate_topt_kernel", "solve3_kernel"} <= names


# -- the kernels on the card ------------------------------------------------------

def score_case(batch, K, N, device, seed=0):
    """Hypotheses near a random rigid motion, the points it maps (half of
    them within TAU), and a mask that drops every fifth point."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(-1, 1, size=(batch, N, 3)).astype(np.float32)
    Q = (P + rng.normal(scale=TAU * 0.6, size=P.shape)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (batch, K, 1, 1))
    R += rng.normal(scale=0.002, size=R.shape).astype(np.float32)
    t = rng.normal(scale=0.005, size=(batch, K, 3)).astype(np.float32)
    mask = np.ones((batch, N), np.float32)
    mask[:, ::5] = 0
    r9 = R.reshape(batch, K, 9).transpose(0, 2, 1).copy()
    t3 = t.transpose(0, 2, 1).copy()
    return [torch.from_numpy(x).to(device) for x in (r9, t3, P, Q, mask)]


def check_score(batch, K, N, masked, mode, device):
    r9, t3, P, Q, mask = score_case(batch, K, N, device)
    m = mask if masked else None
    s, c = kscore.score_hypotheses(r9, t3, P, Q, TAU, mask=m, mode=mode)
    rs, rc = kscore.score_hypotheses_reference(r9, t3, P, Q, TAU, mask=m, mode=mode)
    # Counts: identical, each inlier decision is the same rounded arithmetic.
    assert torch.equal(c, rc)
    assert c.max() > 0
    s2, c2 = kscore.score_hypotheses(r9, t3, P, Q, TAU, mask=m, mode=mode)
    assert torch.equal(s, s2) and torch.equal(c, c2)
    if mode == "weighted":
        # The same non-negative terms summed in another order: at most u per
        # addition in sequence on each side (the kernel's segment and
        # segments, torch's per-thread run), relative to the sum.
        torch.testing.assert_close(s, rs, rtol=kscore.weighted_rtol(N), atol=0.0)
    else:
        assert torch.equal(s, c.float())


@needs_cuda
@pytest.mark.parametrize("mode", ["count", "weighted"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(2, 300, 4999), (2, 300, 100), (3, 2048, 20000), BENCH],
                         ids=["ragged_splits", "one_small_split", "many_splits", "bench"])
def test_score_kernel_splits_on_card(shape, masked, mode):
    check_score(*shape, masked, mode, torch.device("cuda"))


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
def test_score_weighted_bits_independent_of_batch_and_k_on_card(masked):
    """A hypothesis's weight is summed in an order fixed by N alone: scoring
    half the hypotheses (a tensor-parallel rank) or one batch element takes
    another split plan and gives the same bits."""
    r9, t3, P, Q, mask = score_case(3, 2048, 20000, torch.device("cuda"))
    m = mask if masked else None
    full = kscore.score_hypotheses(r9, t3, P, Q, TAU, mask=m, mode="weighted")[0]
    sms = kscore.sm_count(P.device)
    half = (r9[:, :, 1024:].contiguous(), t3[:, :, 1024:].contiguous(), P, Q)
    one = (r9[1:2], t3[1:2], P[1:2], Q[1:2])
    splits = kscore.score_plan(3, 2048, 20000, sms).splits
    assert kscore.score_plan(3, 1024, 20000, sms).splits != splits
    assert kscore.score_plan(1, 2048, 20000, sms).splits != splits
    got = kscore.score_hypotheses(*half, TAU, mask=m, mode="weighted")[0]
    assert torch.equal(got, full[:, 1024:])
    got = kscore.score_hypotheses(*one, TAU, mask=None if m is None else m[1:2],
                                  mode="weighted")[0]
    assert torch.equal(got, full[1:2])


def anchor_case(batch, N, A, device, seed=0):
    """Random points with planted ties: groups of three columns with the same
    coordinates score alike against every other anchor. A mask drops every
    seventh column outside the groups; the anchors avoid the groups."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(0, 0.4, size=(batch, N, 3)).astype(np.float32)
    Q = (P + rng.normal(scale=0.005, size=P.shape)).astype(np.float32)
    perm = rng.permutation(N)
    groups = perm[:3 * min(3, N // 3)].reshape(-1, 3)
    for g in groups:
        P[:, g] = P[:, g[:1]]
        Q[:, g] = Q[:, g[:1]]
    mask = np.ones((batch, N), np.float32)
    mask[:, ::7] = 0
    mask[:, groups.reshape(-1)] = 1
    free = np.setdiff1d(np.arange(N), groups.reshape(-1))
    anchors = np.stack([rng.choice(free, size=min(A, len(free)), replace=False)
                        for _ in range(batch)]).astype(np.int64)
    t = [torch.from_numpy(x).to(device) for x in (P, Q, mask, anchors)]
    return (*t, groups)


def check_anchor_kernel(B, N, device):
    # 41 anchors: a ragged last block at every W (8, 5, 2, ...).
    P, Q, mask, anchors, groups = anchor_case(2, N, 41, device)
    args = (P, Q, anchors, B, 0.05, 0.01)
    kw = dict(mask=mask, anchor_mask=torch.gather(mask, 1, anchors))
    stream = ktri.anchor_neighbors_stream(*args, **kw, chunk_n=256)
    ref = ktri.anchor_neighbors_reference(*args, **kw)
    modes = [{}, {"emit_candidates": True}] + ([{"top_t": min(4, B * (B - 1) // 2)}]
                                                if B > 1 else [])
    for extra in modes:
        got = ktri.anchor_neighbors(*args, **kw, **extra)
        # The whole row's selection equals the streamed kernel's over
        # 256-column chunks bit for bit (a total order), and the plain
        # version's scores.
        assert torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1])
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6)
        # Planted ties: members of a group score alike, so the selected ones
        # are the group's lowest column ids, in ascending order.
        sel = got[1].cpu().numpy()
        for g in np.sort(groups, axis=1):
            hit = np.isin(sel, g)
            for row, h in zip(sel.reshape(-1, B), hit.reshape(-1, B)):
                picked = row[h]
                np.testing.assert_array_equal(picked, g[:len(picked)])
        if "emit_candidates" in extra:
            want = ktri.anchor_neighbors_reference(*args, **kw, **extra)[2]
            torch.testing.assert_close(got[2], want, rtol=0, atol=1e-5)
        if "top_t" in extra:
            ct = ktri.candidate_topt(got[0], got[1], P, Q, extra["top_t"], 0.05, 0.01)
            assert all(torch.equal(x, y) for x, y in zip(ct, got[2:]))


@needs_cuda
@pytest.mark.parametrize("B", [1, 12, 16, 32])
@pytest.mark.parametrize("n", ["B", 33, 1000, 2048, 4096])
def test_anchor_kernel_shapes_on_card(B, n):
    check_anchor_kernel(B, B if n == "B" else n, torch.device("cuda"))


# -- degree_plan ------------------------------------------------------------------

# (batch, R, C): one ring step at kitti with two ranks, the 3DMatch point's SP
# slice, the bench point, the attribution pair, ragged and tiny shapes.
RING = (2, 25000, 25000)
SP_SLICE = (32, 1024, 2048)
DEG_BENCH = (128, 1000, 1000)
ATTRIBUTION = (1, 50000, 50000)
DEGREE_SHAPES = [RING, SP_SLICE, DEG_BENCH, ATTRIBUTION, (2, 1000, 3000), (1, 3000, 3000),
                 (128, 500, 500), (2, 50000, 50000), (3, 257, 511), (1, 1, 1), (2, 5, 0)]


@pytest.mark.parametrize("shape", DEGREE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_degree_splits_cover_every_column_once(shape, sms):
    batch, R, C = shape
    plan = kcompat.degree_plan(batch, R, C, sms)
    assert plan.rows in kcompat.ROWS_PER_THREAD
    rows_a_tile = kcompat.THREADS * plan.rows
    assert plan.tiles * rows_a_tile >= R > (plan.tiles - 1) * rows_a_tile
    assert plan.segments == -(-C // kcompat.SEGMENT)
    assert 1 <= plan.splits <= max(1, plan.segments)
    covered = np.zeros(C, np.int64)
    for s in range(plan.splits):
        lo, hi = plan.split_segments(s)
        assert lo < hi or C == 0, f"split {s} is empty"
        covered[lo * kcompat.SEGMENT:hi * kcompat.SEGMENT] += 1   # whole segments
    assert (covered == 1).all()
    assert plan.blocks == plan.tiles * plan.splits * batch


@pytest.mark.parametrize("shape", [RING, SP_SLICE, DEG_BENCH, ATTRIBUTION],
                         ids=["ring", "sp_slice", "bench", "attribution"])
@pytest.mark.parametrize("sms", [H100_SMS, 114, 200])
def test_degree_plan_reaches_block_target(shape, sms):
    """FULL_BLOCKS_PER_SM blocks a SM, or the most blocks the shape allows:
    one row a thread and one column segment a block."""
    batch, R, C = shape
    plan = kcompat.degree_plan(batch, R, C, sms)
    full = kcompat.FULL_BLOCKS_PER_SM * sms
    assert plan.blocks >= full or (plan.rows == 1 and plan.splits == plan.segments)
    if plan.splits > 1:
        assert plan.tiles * batch < full and plan.splits == plan.segments
    if plan.rows == 1:
        # Two rows a thread would have given too few blocks.
        assert -(-R // (2 * kcompat.THREADS)) * batch * plan.segments < full


def test_degree_plan_at_the_ports_shapes():
    """2 rows a thread where the grid stays full, 1 where it does not; one
    column segment a block at every shape the port runs."""
    got = {name: kcompat.degree_plan(*shape, H100_SMS) for name, shape in
           (("ring", RING), ("sp", SP_SLICE), ("bench", DEG_BENCH), ("attr", ATTRIBUTION))}
    assert {k: (p.rows, p.splits) for k, p in got.items()} == {
        "ring": (2, 98), "sp": (1, 8), "bench": (1, 4), "attr": (2, 196)}
    assert got["ring"].blocks == 2 * 98 * 98


@pytest.mark.parametrize("shape", [(2200, 1000, 1000), (64, 50000, 50000), (9000, 200, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_degree_plan_keeps_one_split_when_the_row_tiles_fill_the_card(shape):
    batch, R, C = shape
    plan = kcompat.degree_plan(batch, R, C, H100_SMS)
    assert plan.tiles * batch >= kcompat.FULL_BLOCKS_PER_SM * H100_SMS
    assert plan.splits == 1


@pytest.mark.parametrize("shape", [(1, 1_000_000, 1_000_000), (4, 300_000, 300_000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_degree_plan_bounds_the_split_scratch(shape):
    """Past SCRATCH_BYTES of segment sums the loop runs unsplit (the same
    bits, no scratch); the port's shapes stay far below it."""
    batch, R, C = shape
    plan = kcompat.degree_plan(batch, R, C, H100_SMS)
    assert 4 * batch * plan.segments * R > kcompat.SCRATCH_BYTES and plan.splits == 1
    for shape in (RING, SP_SLICE, DEG_BENCH, ATTRIBUTION, (2, 50000, 50000)):
        plan = kcompat.degree_plan(*shape, H100_SMS)
        assert plan.splits > 1
        assert 4 * plan.batch * plan.segments * shape[1] <= kcompat.SCRATCH_BYTES // 8


def test_degree_plan_ragged_rows_and_columns():
    plan = kcompat.degree_plan(2, 1000, 3000, H100_SMS)
    assert (plan.rows, plan.tiles, plan.segments, plan.splits) == (1, 8, 12, 12)
    assert plan.tiles * kcompat.THREADS * plan.rows >= 1000
    bounds = [plan.split_segments(s) for s in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == 12
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # Fewer splits than segments (an explicit plan) differ in size by at most
    # one segment.
    odd = kcompat.DegreePlan(batch=2, rows=2, tiles=4, splits=5, segments=12)
    sizes = [hi - lo for lo, hi in (odd.split_segments(s) for s in range(5))]
    assert sum(sizes) == 12 and max(sizes) - min(sizes) <= 1


def test_degree_plan_check_refuses_what_the_kernel_cannot_run():
    plan = kcompat.degree_plan(2, 1000, 3000, H100_SMS)
    kcompat.check_plan(plan, 2, 1000, 3000)
    for bad in (dict(rows=4, tiles=2), dict(tiles=7), dict(batch=3), dict(splits=13),
                dict(splits=0), dict(segments=11, splits=11)):
        with pytest.raises(ValueError):
            kcompat.check_plan(dataclasses.replace(plan, **bad), 2, 1000, 3000)


def test_degree_plan_matches_the_kernel_source():
    assert _csrc_int("kThreads", "degree_loops.cuh") == kcompat.THREADS
    assert _csrc_int("kSegment", "degree_loops.cuh") == kcompat.SEGMENT
    assert (_csrc_int("kRowsWide", "degree_loops.cuh"),
            _csrc_int("kRowsNarrow", "degree_loops.cuh")) == kcompat.ROWS_PER_THREAD


def test_plan_sweep_covers_every_grid_it_names():
    """`scripts/exp_degree_plan.py` sweeps both rows a thread and splits from
    1 to one a segment at every shape, each a grid the kernel can run."""
    from saccot_tpu_torch.scripts import exp_degree_plan as xplan

    for _, batch, R, C in xplan.SHAPES:
        plans = list(xplan.plans(batch, R, C))
        segments = -(-C // kcompat.SEGMENT)
        for plan in plans:
            kcompat.check_plan(plan, batch, R, C)
        assert {p.rows for p in plans} == set(kcompat.ROWS_PER_THREAD)
        assert {p.splits for p in plans} >= {1, segments}
        assert kcompat.degree_plan(batch, R, C, H100_SMS) in plans


def test_ring_step_has_no_loop_of_its_own():
    """The ring step, the direct route and the two-sided variants are
    instances of the one two-sided loop of degree_loops.cuh."""
    for src in ("ring_degrees.cu", "compat_degrees.cu", "compat_ops.cu"):
        text = (CSRC / src).read_text()
        assert '#include "degree_loops.cuh"' in text and "launch_two_sided<" in text
        assert "__global__" not in text and "for (" not in text, src


DEG_PARAMS = SacCotParams(compat_tau=0.05, min_separation=0.1, inlier_tau=0.05)


def degree_case(batch, n, device, seed=0):
    """Kitti-like points (70% outliers) and a mask that drops about a fifth."""
    P, Q, _ = kitti_problem_batch(range(KITTI_SEED + seed, KITTI_SEED + seed + batch),
                                  device=device, n=n)
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy((rng.uniform(size=(batch, n)) > 0.2).astype(np.float32)).to(device)
    return P, Q, mask


def check_degree_kernel(batch, R, C, offset, masked, device):
    """degrees(mxu=False) of rows offset:offset + R against all C columns,
    within rtol 1e-5 / atol 2e-3 of the plain version, the same bits in two
    calls."""
    P, Q, mask = degree_case(batch, C, device)
    rows = slice(offset, offset + R)
    args = (P[:, rows].contiguous(), Q[:, rows].contiguous(), P, Q, KITTI_PARAMS)
    kw = dict(row_offset=offset)
    if masked:
        kw.update(mask_rows=mask[:, rows].contiguous(), mask_cols=mask)
    got = kcompat.degrees(*args, **kw, mxu=False)
    ref = kcompat.degrees_reference(*args, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-3)
    assert torch.equal(got, kcompat.degrees(*args, **kw, mxu=False))
    return got


def explicit_plans(batch, R, C):
    """degree_plan's and other plans of both rows a thread: one split, a few
    splits of unequal size, one segment a block."""
    segments = -(-C // kcompat.SEGMENT)
    out = []
    for rows in kcompat.ROWS_PER_THREAD:
        tiles = -(-R // (kcompat.THREADS * rows))
        for splits in sorted({1, min(segments, 5), max(1, segments)}):
            out.append(kcompat.DegreePlan(batch=batch, rows=rows, tiles=tiles, splits=splits,
                                          segments=segments))
    return out


# (batch, R, C, row offset): ragged R and C, offsets that cut a tile's
# diagonal, a slice of an SP rank's rows, many small pairs.
DEGREE_CARD_SHAPES = {"ragged": (2, 1000, 3000, 1000), "ragged_tail": (2, 777, 5000, 4000),
                      "square": (1, 3000, 3000, 0), "sp_slice": (8, 1024, 2048, 1024),
                      "many_pairs": (200, 500, 700, 100)}


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", DEGREE_CARD_SHAPES)
def test_degree_kernel_matches_plain_over_plans_on_card(name, masked):
    """The kernel within rtol 1e-5 / atol 2e-3 of its plain version under
    degree_plan's plan and the same bits under every other plan."""
    batch, R, C, offset = DEGREE_CARD_SHAPES[name]
    got = check_degree_kernel(batch, R, C, offset, masked, torch.device("cuda"))
    P, Q, mask = degree_case(batch, C, torch.device("cuda"))
    rows = slice(offset, offset + R)
    mr, mc = (mask[:, rows].contiguous(), mask) if masked else (None, None)
    for plan in explicit_plans(batch, R, C):
        again = kcompat._two_sided(P[:, rows].contiguous(), Q[:, rows].contiguous(), P, Q,
                                   KITTI_PARAMS, offset, mr, mc, "compat_degrees_direct",
                                   plan=plan)
        assert torch.equal(again, got), plan


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
def test_degree_bits_independent_of_row_and_batch_slice_on_card(masked):
    """Each row is summed in 256-column segments, then segment by segment, so
    the second half of the rows (an SP rank's slice) and batch slices give
    the full call's bits, on grids of other tiles and rows a thread."""
    dev = torch.device("cuda")
    n = 6000
    P, Q, mask = degree_case(8, n, dev)
    m = dict(mask_rows=mask, mask_cols=mask) if masked else {}
    full = kcompat.degrees(P, Q, P, Q, KITTI_PARAMS, **m, mxu=False)
    h = n // 2
    ms = dict(mask_rows=mask[:, h:].contiguous(), mask_cols=mask) if masked else {}
    got = kcompat.degrees(P[:, h:].contiguous(), Q[:, h:].contiguous(), P, Q, KITTI_PARAMS,
                          row_offset=h, **ms, mxu=False)
    assert torch.equal(got, full[:, h:])
    for lo, hi in ((2, 5), (6, 7)):
        mb = dict(mask_rows=mask[lo:hi], mask_cols=mask[lo:hi]) if masked else {}
        got = kcompat.degrees(P[lo:hi], Q[lo:hi], P[lo:hi], Q[lo:hi], KITTI_PARAMS, **mb,
                              mxu=False)
        assert torch.equal(got, full[lo:hi])


@needs_cuda
@pytest.mark.parametrize("n", [1000, 2048, 5000])
def test_ring_step_at_d1_equals_the_direct_route_on_card(n):
    """One ring step over the rank's own block on a zeroed deg adds the row
    sums of the same loop to 0: the direct route's degrees bit for bit."""
    P, Q, _ = degree_case(2, n, torch.device("cuda"), seed=1)
    blk = kring.pack_block(P, Q)
    step = kring.ring_degrees_step(blk, blk, torch.zeros((2, n), device="cuda"), 0, 0,
                                   DEG_PARAMS)
    assert torch.equal(step, kcompat.degrees(P, Q, P, Q, DEG_PARAMS, mxu=False))


def solve_case(batch, n, k, device, seed=0):
    """Kitti-like points and random triples of distinct points, a few with a
    point repeated or all three the same (degenerate: the column select then
    hangs on the last bit)."""
    rng = np.random.default_rng(seed)
    P, Q, _ = kitti_problem_batch(range(KITTI_SEED + seed, KITTI_SEED + seed + batch),
                                  device="cpu", n=n)
    tri = np.stack([np.stack([rng.choice(n, size=3, replace=False) for _ in range(k)])
                    for _ in range(batch)]).astype(np.int64)
    tri[:, :4, 2] = tri[:, :4, 1]      # two points the same
    tri[:, 4:6] = tri[:, 4:6, :1]      # all three the same
    return P.to(device), Q.to(device), torch.from_numpy(tri).to(device)


@needs_cuda
@pytest.mark.parametrize("threads", [32, 64, 128, 256])
@pytest.mark.parametrize("shape", [(2, 3000, 2048), (3, 1000, 257), (1, 500, 40)],
                         ids=["kitti_k", "ragged", "below_a_block"])
def test_solve_every_plan_equals_plain_on_card(shape, threads):
    """Every block size gives the plain version's bits: each operation is
    rounded on its own, in the plain order, on both sides."""
    P, Q, tri = solve_case(*shape, torch.device("cuda"))
    want = ksolve.solve3_reference(P, Q, tri)
    plan = ksolve.make_solve_plan(shape[0], shape[2], threads)
    got = ksolve._solve(P, Q, tri, plan)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
