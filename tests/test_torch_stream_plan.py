"""The streamed anchor top-B (`csrc/anchor_topb_stream.cu`): its launch plan,
its selection against the JAX package's streamed kernel, and the kernel on
the card.

The kernel splits the column axis into chunks, selects each chunk's top-B
with one warp and merges the chunks' lists in the same launch. The key
(score desc, column asc) is a total order, so the top-B of the chunks'
top-Bs is the row's top-B: `chunked_top_b` below does the same in torch, and
on inputs whose scores are exact on both sides it equals
`anchor_neighbors_stream_pallas` (interpret mode) bit for bit. Kernel tests
need a card and skip here (a CUDA kernel has no CPU mode).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saccot_tpu.kernels.triangles import anchor_neighbors_stream_pallas
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels import triangles as ktri
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch

torch.set_num_threads(2)

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
CSRC = Path(ktri.__file__).resolve().parent.parent / "csrc"

# (batch, A, N, B): the kitti point, N just above MAX_N_FUSED, an anchor
# shard of kitti, a ragged shape, N == B, the smallest shape.
KITTI = (2, 512, 50000, 16)
SHAPES = [KITTI, (2, 512, 5000, 16), (2, 256, 50000, 16), (2, 41, 4999, 12), (1, 5, 16, 16),
          (1, 1, 1, 1)]


def _ids(shape):
    return "x".join(map(str, shape))


# -- stream_plan ------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("sms", [132, 114])
def test_stream_plan_covers_every_column_once(shape, sms):
    batch, A, N, B = shape
    plan = ktri.stream_plan(batch, A, N, B, sms)
    assert plan == ktri.make_stream_plan(batch, A, N, plan.warps, plan.chunk_n)
    assert 1 <= plan.warps <= ktri.MAX_WARPS
    assert plan.tiles * plan.warps >= A > (plan.tiles - 1) * plan.warps
    covered = np.zeros(N, np.int64)
    for c in range(plan.chunks):
        lo, hi = c * plan.chunk_n, min(N, (c + 1) * plan.chunk_n)
        assert lo < hi, f"chunk {c} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert plan.blocks == plan.tiles * plan.chunks * batch


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_stream_plan_fits_shared_memory_and_scratch(shape):
    batch, A, N, B = shape
    plan = ktri.stream_plan(batch, A, N, B, 132)
    # Within the 48 KB a block gets without an opt-in.
    assert plan.smem_bytes == 4 * plan.warps * plan.chunk_n <= ktri.ANCHOR_SMEM_BUDGET == 48 * 1024
    assert plan.scratch_bytes(A, B) <= kcompat.SCRATCH_BYTES // 100
    assert plan.chunks == 1 or plan.scratch_bytes(A, B) == 8 * batch * A * plan.chunks * B


def test_stream_plan_at_the_kitti_point():
    plan = ktri.stream_plan(*KITTI, 132)
    assert plan.chunks > 1 and plan.blocks >= 8 * 132
    assert plan.chunk_n % 32 == 0   # every lane of a warp takes as many columns


@pytest.mark.parametrize("chunk_n", [7, 1024, 3000, 4096, 12288])
def test_stream_plan_takes_the_chunk_width_it_is_given(chunk_n):
    """`chunk_n` sets the chunks; the plan drops warps until the block fits,
    so any width up to one warp's 48 KB is a plan."""
    plan = ktri.stream_plan(2, 512, 3000, 16, 132, chunk_n=chunk_n)
    assert plan.chunk_n == min(chunk_n, 3000)
    assert plan.chunks == -(-3000 // plan.chunk_n)
    assert plan.smem_bytes <= ktri.ANCHOR_SMEM_BUDGET
    if plan.chunks == 1:
        assert plan.scratch_bytes(512, 16) == 0
    if chunk_n == 7:    # fewer columns a chunk than B: 428 full chunks and one of 4
        assert (plan.chunks, 3000 - (plan.chunks - 1) * 7) == (429, 4)
    if chunk_n == 3000:  # one chunk; 4 warps of 3,000 columns fit in 48 KB
        assert plan.warps == ktri.STREAM_WARPS
    if chunk_n == 4096:  # one chunk of 3,000 columns, as at 3000
        assert plan == ktri.stream_plan(2, 512, 3000, 16, 132, chunk_n=3000)
        wide = ktri.stream_plan(2, 512, 50000, 16, 132, chunk_n=4096)
        assert (wide.warps, wide.smem_bytes) == (3, 48 * 1024)   # the whole 48 KB
    if chunk_n == 12288:  # one chunk; 4 warps of 3,000 columns, as the chunk is N
        assert plan == ktri.stream_plan(2, 512, 3000, 16, 132, chunk_n=3000)


def test_stream_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        ktri.stream_plan(2, 512, 3000, ktri.MAX_NEIGHBORS + 1, 132)
    with pytest.raises(ValueError):
        ktri.stream_plan(1, 4, 8, 12, 132)                       # B > N
    with pytest.raises(ValueError):
        ktri.stream_plan(2, 512, 50000, 16, 132, chunk_n=0)
    with pytest.raises(ValueError):                               # one warp's row > 48 KB
        ktri.stream_plan(2, 512, 50000, 16, 132, chunk_n=12289)
    with pytest.raises(ValueError):                               # lists past SCRATCH_BYTES
        ktri.stream_plan(64, 4096, 1_000_000, 32, 132, chunk_n=256)


def test_stream_plan_matches_the_kernel_source():
    src = (CSRC / "anchor_topb_stream.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const("kMaxWarps") == ktri.MAX_WARPS
    assert const("kMaxB") == ktri.MAX_NEIGHBORS


def test_one_selection_loop():
    """The fused and streamed kernels select with the one warp loop of
    common.cuh, and so do the candidates' top-T rounds; no kernel has a loop
    of rounds, a block arg-max or a knockout of its own."""
    common = (CSRC / "common.cuh").read_text()
    assert "int warp_top_b(" in common and "struct Best2" in common
    for src in ("anchor_topb.cu", "anchor_topb_stream.cu"):
        text = (CSRC / src).read_text()
        assert "saccot::warp_top_b(" in text, src
        assert "saccot::warp_argmax(" not in text and "block_argmax" not in text, src
        assert "struct Best2" not in text and "for (int r = 0; r < B" not in text, src
    # The candidate kernel runs the candidate helpers at the fused kernel's
    # warp scope: no block scope, block arg-max or block-form overload remains.
    assert "saccot::WarpScope scope{}" in (CSRC / "candidate_topt.cu").read_text()
    assert "BlockScope" not in common and "block_argmax" not in common
    assert "The block form" not in common
    assert len(re.findall(r"void candidate_grid\(", common)) == 1
    assert len(re.findall(r"void grid_top_t\(", common)) == 1
    # The candidates' top-T rounds run on the same loop.
    top_t = common[common.index("void grid_top_t("):]
    assert "warp_top_b(best, rounds" in top_t and "warp_argmax(" not in top_t


def test_plan_sweep_names_grids_the_kernel_runs():
    """`scripts/exp_stream_plan.py` sweeps W x chunk_n at each of its shapes;
    each is a grid `_stream` accepts, and stream_plan's plan is among
    them."""
    from saccot_tpu_torch.scripts import exp_stream_plan as xplan

    for _, batch, A, N in xplan.SHAPES:
        plans = list(xplan.plans(batch, A, N))
        assert len(plans) == len(xplan.WARPS) * len(xplan.CHUNK_N)
        for plan in plans:
            assert plan == ktri.make_stream_plan(batch, A, N, plan.warps, plan.chunk_n)
        assert sum(p.smem_bytes <= ktri.ANCHOR_SMEM_BUDGET for p in plans) >= 10
        assert ktri.stream_plan(batch, A, N, KITTI_PARAMS.neighbors_per_anchor, 132) in plans


# -- the chunked selection against the JAX package's streamed kernel ---------------

TAU, SEP = 0.25, 0.1   # 1 / TAU = 4: the score's product is exact
N, A, B = 300, 24, 12


def chunked_top_b(S: torch.Tensor, k: int, chunk_n: int):
    """Top-k of each row of S [..., N] as the kernel takes it: each chunk's
    top-k (ending in (-inf, N) where the chunk has fewer than k columns),
    then the top-k of the chunks' lists laid end to end in chunk order."""
    n = S.shape[-1]
    vals, cols = [], []
    for c0 in range(0, n, chunk_n):
        v, i = ktri.topk_stable(S[..., c0:c0 + chunk_n], k)
        short = k - v.shape[-1]
        vals.append(torch.cat([v, v.new_full((*v.shape[:-1], short), -torch.inf)], -1))
        cols.append(torch.cat([i + c0, i.new_full((*i.shape[:-1], short), n)], -1))
    v, pos = ktri.topk_stable(torch.cat(vals, -1), k)
    return v, torch.gather(torch.cat(cols, -1), -1, pos)


@pytest.fixture(scope="module")
def grid_case():
    """Points on a 1/16 grid and targets moved by multiples of 1/64, so every
    squared distance is exact in float32 and every score is the same
    correctly rounded value on both sides, whatever contracts into an FMA
    (many ties, too). A column mask drops every ninth column; anchor 5 is
    masked (an all-zero row: the lowest columns win). The JAX package's
    streamed selections: three column blocks of 128."""
    rng = np.random.default_rng(7)
    P = (rng.integers(0, 16, size=(2, N, 3)) / 16).astype(np.float32)
    Q = (P + rng.integers(-3, 4, size=P.shape) / 64).astype(np.float32)
    mask = (np.arange(N) % 9 != 4).astype(np.float32)[None].repeat(2, 0)
    anchors = np.stack([rng.choice(N, size=A, replace=False) for _ in range(2)])
    amask = np.take_along_axis(mask, anchors, 1)
    amask[:, 5] = 0.0
    want_s, want_i = [], []
    for b in range(2):
        s, i = anchor_neighbors_stream_pallas(
            jnp.asarray(P[b]), jnp.asarray(Q[b]), jnp.asarray(anchors[b], jnp.int32), B, TAU,
            SEP, mask=jnp.asarray(mask[b]), anchor_mask=jnp.asarray(amask[b]), tile_n=128)
        want_s.append(np.asarray(s))
        want_i.append(np.asarray(i))
    return dict(P=P, Q=Q, mask=mask, anchors=anchors.astype(np.int64), amask=amask,
                want_s=np.stack(want_s), want_i=np.stack(want_i).astype(np.int64))


def exact_rows(case) -> torch.Tensor:
    """The anchors' score rows [2, A, N] in float32 in the kernels' order of
    operations, with numpy's correctly rounded roots (XLA's on the CPU are
    too; torch's CPU sqrt is off by an ulp on about 0.5% of inputs)."""
    P, Q, mask, anchors, amask = (case[k] for k in ("P", "Q", "mask", "anchors", "amask"))

    def dist(X):
        d = np.take_along_axis(X, anchors[..., None], 1)[:, :, None, :] - X[:, None, :, :]
        return np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])

    dp, dq = dist(P), dist(Q)
    delta = np.abs(dp - dq)
    ok = (delta < np.float32(TAU)) & (np.minimum(dp, dq) > np.float32(SEP))
    s = np.where(ok, np.float32(1) - delta * np.float32(1 / TAU), np.float32(0))
    s[anchors[..., None] == np.arange(N)] = 0
    s = (s * mask[:, None, :]) * amask[:, :, None]
    assert s.dtype == np.float32
    return torch.from_numpy(s)


@pytest.mark.parametrize("chunk_n", [7, 64, 100, N], ids=lambda c: f"chunk{c}")
def test_chunked_selection_equals_pallas_stream(grid_case, chunk_n):
    """Chunks of fewer columns than B, of a power of two, ragged, and one
    chunk: the chunks' top-Bs merged give the JAX package's streamed
    selections bit for bit, scores and columns."""
    got_s, got_i = chunked_top_b(exact_rows(grid_case), B, chunk_n)
    np.testing.assert_array_equal(got_s.numpy(), grid_case["want_s"])
    np.testing.assert_array_equal(got_i.numpy(), grid_case["want_i"])
    # The masked anchor's row is all zero: its first B columns, in order.
    np.testing.assert_array_equal(got_i[:, 5].numpy(), np.tile(np.arange(B), (2, 1)))
    assert (got_s[:, 5] == 0).all()
    assert (got_s[:, :5] > 0).any() and len(np.unique(got_s.numpy())) > 10


# -- the kernel on the card -------------------------------------------------------

def card_plans(batch, A, N):
    """Other grids than stream_plan's that fit 48 KB of shared memory: 1 to 8
    warps, chunks smaller than B, ragged, and one chunk."""
    plans = (ktri.make_stream_plan(batch, A, N, warps, chunk_n)
             for warps in (1, 3, 8) for chunk_n in (5, 256, 1000, N))
    return [p for p in plans if p.smem_bytes <= ktri.ANCHOR_SMEM_BUDGET]


def grid_card_case(batch, n, a, seed):
    """`grid_case`'s points on the card, with a column mask and one masked
    anchor."""
    rng = np.random.default_rng(seed)
    P = (rng.integers(0, 16, size=(batch, n, 3)) / 16).astype(np.float32)
    Q = (P + rng.integers(-3, 4, size=P.shape) / 64).astype(np.float32)
    mask = (rng.uniform(size=(batch, n)) > 0.1).astype(np.float32)
    anchors = np.stack([rng.choice(n, size=a, replace=False) for _ in range(batch)])
    amask = np.take_along_axis(mask, anchors, 1)
    amask[:, 0] = 0.0
    return [torch.from_numpy(x).cuda() for x in (P, Q, mask, anchors.astype(np.int64), amask)]


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(2, 3000, 37), (3, 777, 9), (1, 16, 16)],
                         ids=["n3000", "ragged", "n_equals_b"])
def test_stream_kernel_equals_plain_over_plans_on_card(shape, masked):
    """On exact scores the kernel equals the plain version bit for bit,
    scores and columns (ties included), under stream_plan's plan and every
    other grid; each half of the anchors run alone gives the same rows."""
    batch, n, a = shape
    P, Q, mask, anchors, amask = grid_card_case(batch, n, a, seed=n)
    args = (P, Q, anchors, 16, TAU, SEP)
    kw = dict(mask=mask, anchor_mask=amask) if masked else {}
    want = ktri.anchor_neighbors_reference(*args, **kw)
    got = ktri.anchor_neighbors_stream(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for plan in card_plans(batch, a, n):
        for floors in (True, False):
            again = ktri._stream(*args, kw.get("mask"), kw.get("anchor_mask"), plan,
                                 floors=floors)
            assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1]), plan
    h = a // 2
    for lo, hi in ((0, h), (h, a)):
        kh = dict(mask=mask, anchor_mask=amask[:, lo:hi].contiguous()) if masked else {}
        part = ktri.anchor_neighbors_stream(P, Q, anchors[:, lo:hi].contiguous(), 16, TAU, SEP,
                                            **kh)
        assert torch.equal(part[0], got[0][:, lo:hi]) and torch.equal(part[1], got[1][:, lo:hi])


@needs_cuda
def test_stream_kernel_matches_plain_at_kitti_on_card():
    """The kitti pair (N=50,000, 512 anchors of highest degree): scores within
    1e-6 of the plain version, columns equal off ties (judged against a
    top-(B+1)), the same bits in two calls and under another plan."""
    kp = KITTI_PARAMS
    P, Q, _ = kitti_problem_batch([KITTI_SEED], device="cuda")
    anchors = ktri.topk_stable(kcompat.degrees(P, Q, P, Q, kp), kp.num_anchors)[1]
    args = (P, Q, anchors, kp.neighbors_per_anchor, kp.compat_tau, kp.min_separation)
    got = ktri.anchor_neighbors_stream(*args)
    ref = ktri.anchor_neighbors_reference(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6)
    wider = ktri.anchor_neighbors_reference(*args[:3], args[3] + 1, *args[4:])[0]
    close = (wider[..., :-1] - wider[..., 1:]).abs() < 1e-6
    tie = torch.zeros_like(wider, dtype=torch.bool)
    tie[..., :-1] |= close
    tie[..., 1:] |= close
    clear = ~tie[..., :-1]
    assert torch.equal(got[1][clear], ref[1][clear])
    assert all(torch.equal(x, y) for x, y in zip(got, ktri.anchor_neighbors_stream(*args)))
    other = ktri.anchor_neighbors_stream(*args, chunk_n=4096)
    assert all(torch.equal(x, y) for x, y in zip(got, other))
