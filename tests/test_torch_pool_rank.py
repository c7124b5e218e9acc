"""The exact pool's ranking, `kernels.triangles.pool_rank`: cross-anchor
dedup, canonical triples and the global top-K.

On the CPU the wrapper takes its plain version, held here to a direct
reading of the rule (a loop over every candidate) on hand-made cases; its
argument checks and the kernel's shared-memory plan are pure Python. On the
card the kernel is held to the plain version bit for bit on the same cases
and on each benchmark cell's first batch, and `register_batch` to the
composition the kernel replaced (the plain ranking inside the kernel
route).
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from saccot_tpu_torch.kernels import _build
from saccot_tpu_torch.kernels import triangles as ktri

REPO = Path(__file__).resolve().parents[1]

# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")


def brute_pool(anchors, nbr_s, nbr_idx, cand, K, dedup):
    """The pool by the rule's words: a candidate (a, b1, b2) is a duplicate
    iff one of its neighbour vertices is the anchor of a smaller slot whose
    valid row holds anchors[a] and the other neighbour; entries by score
    descending, then flat index; (0, 0, 0) / -1 past the candidates."""
    anchors, nbr_s, nbr_idx, cand = (x.cpu().numpy() for x in (anchors, nbr_s, nbr_idx, cand))
    batch, A, B = nbr_idx.shape
    pairs = [(b1, b2) for b1 in range(B) for b2 in range(b1 + 1, B)]
    triples = np.zeros((batch, K, 3), np.int64)
    scores = np.full((batch, K), -1.0, np.float32)
    for b in range(batch):
        slot = {int(v): i for i, v in enumerate(anchors[b])}
        valid = nbr_s[b] > 0

        def dup_through(a, via, other):
            x = slot.get(int(nbr_idx[b, a, via]), -1)
            if not valid[a, via] or not 0 <= x < a:
                return False
            row = {int(nbr_idx[b, x, u]) for u in range(B) if valid[x, u]}
            return int(anchors[b, a]) in row and int(other) in row

        entries = []
        for a in range(A):
            for p, (b1, b2) in enumerate(pairs):
                j, k = nbr_idx[b, a, b1], nbr_idx[b, a, b2]
                s = cand[b, a, p]
                tri = (anchors[b, a], j, k)
                if dedup:
                    if dup_through(a, b1, k) or dup_through(a, b2, j):
                        s = np.float32(-1.0)
                    tri = tuple(sorted(tri))
                entries.append((float(s), a * len(pairs) + p, tri))
        entries.sort(key=lambda e: (-e[0], e[1]))
        for r, (s, _, tri) in enumerate(entries[:K]):
            triples[b, r] = tri
            scores[b, r] = s
    return triples, scores, scores > 0


def _case(anchors, rows, row_s, cand, K, dedup=True):
    anchors = torch.tensor(anchors, dtype=torch.int64)
    nbr_idx = torch.tensor(rows, dtype=torch.int64)
    nbr_s = torch.tensor(row_s, dtype=torch.float32)
    cand = torch.tensor(cand, dtype=torch.float32)
    return dict(anchors=anchors, nbr_s=nbr_s, nbr_idx=nbr_idx, cand=cand, K=K, dedup=dedup,
                n_nodes=int(max(anchors.max(), nbr_idx.max())) + 1)


def _random_case(seed, batch=3, n=20, A=8, B=6, K=40, self_rows=False, levels=0):
    """Anchors among n nodes and rows of B distinct nodes (an anchor may
    name itself with `self_rows`, as a dense S with a diagonal does), so
    rows overlap and triangles repeat; scores -1 where a selection is
    invalid, else drawn from `levels` values (ties) or continuous."""
    rng = np.random.default_rng(seed)
    anchors = np.stack([rng.choice(n, A, replace=False) for _ in range(batch)])
    rows = np.zeros((batch, A, B), np.int64)
    for b in range(batch):
        for a in range(A):
            pool = np.arange(n) if self_rows else np.delete(np.arange(n), anchors[b, a])
            rows[b, a] = rng.choice(pool, B, replace=False)
    row_s = np.where(rng.random((batch, A, B)) < 0.8, rng.uniform(0.1, 1.0, (batch, A, B)),
                     0.0).astype(np.float32)
    n_pairs = B * (B - 1) // 2
    b1, b2 = np.triu_indices(B, k=1)
    ok = (row_s[:, :, b1] > 0) & (row_s[:, :, b2] > 0) & (rng.random((batch, A, n_pairs)) < 0.9)
    vals = (rng.integers(1, levels + 1, (batch, A, n_pairs)) * 0.5 if levels
            else rng.uniform(0.3, 3.0, (batch, A, n_pairs)))
    cand = np.where(ok, vals, -1.0).astype(np.float32)
    return _case(anchors, rows, row_s, cand, K)


def _three_anchors(K=8, dedup=True):
    """Triangle (5, 7, 9) held by its three vertices, all anchors (slots 0,
    1, 2): the copies at slots 1 and 2 are duplicates. Anchor 2 (slot 3)
    names 5, 9 and an invalid 7; row 5 does not hold 2, so (2, 5, 9) stays."""
    anchors = [[5, 7, 9, 2]]
    rows = [[[7, 9, 1], [9, 5, 3], [5, 7, 4], [5, 9, 7]]]
    row_s = [[[0.9, 0.8, 0.7], [0.9, 0.6, 0.5], [0.8, 0.7, 0.2], [0.9, 0.8, 0.0]]]
    cand = [[[2.1, 1.5, 1.4], [2.1, 1.2, 1.0], [2.0, 1.1, -1.0], [1.9, -1.0, -1.0]]]
    return _case(anchors, rows, row_s, cand, K, dedup)


CASES = {
    "three_anchors": lambda: _three_anchors(),
    "three_anchors_k_past_candidates": lambda: _three_anchors(K=12),
    "dedup_off": lambda: _three_anchors(dedup=False),
    "all_invalid": lambda: _case([[1, 2, 3]], [[[4, 5, 6, 7]] * 3], [[[0.0] * 4] * 3],
                                 [[[-1.0] * 6] * 3], K=5),
    "fewer_valid_than_k": lambda: _random_case(3, A=6, B=5, K=50),
    "fewer_candidates_than_k": lambda: _case([[3, 0]], [[[1, 2, 0], [3, 1, 2]]],
                                             [[[0.5, 0.4, 0.3], [0.9, 0.2, 0.1]]],
                                             [[[1.2, 0.9, -1.0], [1.0, 1.2, 0.4]]], K=10),
    "equal_scores_under_other_anchors": lambda: _random_case(5, A=8, B=6, K=37, levels=3),
    "random": lambda: _random_case(7),
    "random_dedup_off": lambda: dict(_random_case(8), dedup=False),
    "anchor_in_its_own_row": lambda: _random_case(11, self_rows=True),
    "rows_past_half_a_warp": lambda: _random_case(13, batch=2, n=40, A=12, B=20, K=300),
    "rows_of_max_neighbors": lambda: _random_case(17, batch=1, n=48, A=10, B=32, K=1000),
}


def _args(c, device="cpu"):
    return (c["anchors"].to(device), c["nbr_s"].to(device), c["nbr_idx"].to(device),
            c["cand"].to(device), c["K"], c["dedup"], c["n_nodes"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_pool_follows_the_rule(name):
    """CPU tensors take the plain version; it gives the rule's pool, bit for
    bit, on each hand-made case."""
    c = CASES[name]()
    triples, scores, valid = ktri.pool_rank(*_args(c))
    want = brute_pool(c["anchors"], c["nbr_s"], c["nbr_idx"], c["cand"], c["K"], c["dedup"])
    np.testing.assert_array_equal(triples.numpy(), want[0])
    np.testing.assert_array_equal(scores.numpy(), want[1])
    np.testing.assert_array_equal(valid.numpy(), want[2])
    if name == "three_anchors":
        assert scores[0, :3].tolist() == pytest.approx([2.1, 1.9, 1.5])
        assert triples[0, 0].tolist() == [5, 7, 9] and int(valid[0].sum()) == 7


@pytest.mark.parametrize("bad", ["anchors_int32", "nbr_s_float64", "nbr_idx_int32",
                                 "cand_float64", "cand_shape", "anchors_shape", "k_zero"])
def test_wrapper_refuses_bad_arguments(bad):
    args = list(_args(CASES["random"]()))
    if bad == "anchors_int32":
        args[0] = args[0].to(torch.int32)
    elif bad == "nbr_s_float64":
        args[1] = args[1].double()
    elif bad == "nbr_idx_int32":
        args[2] = args[2].to(torch.int32)
    elif bad == "cand_float64":
        args[3] = args[3].double()
    elif bad == "cand_shape":
        args[3] = args[3][:, :, :-1]
    elif bad == "anchors_shape":
        args[0] = args[0][:, :-1]
    else:
        args[4] = 0
    with pytest.raises((TypeError, ValueError)):
        ktri.pool_rank(*args)


@pytest.mark.parametrize("A, B, K", [(256, 33, 2048), (256, 16, 0), (0, 16, 2048),
                                     (8192, 32, 2048)])
def test_plan_refuses_what_the_kernel_cannot_hold(A, B, K):
    """B past MAX_NEIGHBORS, K < 1, no anchors, or a block that fits in
    shared memory neither way."""
    with pytest.raises(ValueError):
        ktri.pool_rank_plan(A, B, K)


def test_plan_keeps_keys_resident_where_they_fit():
    """The 3DMatch and 3DLoMatch shapes (A=256, B=16: 30,720 candidates)
    keep their keys in shared memory; kitti's (A=512: 61,440) reads them
    again each pass. Every plan fits an H100 block, sorts K rounded up to a
    power of two, and the non-resident plan is the resident one without the
    keys."""
    tdm = ktri.pool_rank_plan(256, 16, 2048)
    kitti = ktri.pool_rank_plan(512, 16, 2048)
    assert tdm.resident and not kitti.resident
    assert tdm.k_pow2 == kitti.k_pow2 == 2048
    for A, plan in ((256, tdm), (512, kitti)):
        assert plan.smem_bytes <= ktri.POOL_RANK_SMEM_LIMIT
        assert plan.smem_bytes == ktri.pool_rank_smem(A, 16, 2048, plan.resident)
    assert tdm.smem_bytes - ktri.pool_rank_smem(256, 16, 2048, False) == 4 * 256 * 120
    assert ktri.pool_rank_smem(512, 16, 2048, True) > ktri.POOL_RANK_SMEM_LIMIT
    # Fewer candidates than K: the sort is as wide as the candidates.
    assert ktri.pool_rank_plan(2, 3, 10).k_pow2 == 8
    assert ktri.pool_rank_plan(4, 2, 1).k_pow2 == 1


def test_plan_repeats_the_kernels_layout():
    """The plan's constants are the kernel's: threads a block, histogram
    bins, the block's words and the widest row."""
    src = (REPO / "saccot_tpu_torch" / "csrc" / "pool_rank.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))

    assert const("kThreads") == ktri.POOL_RANK_THREADS
    assert const("kBins") == ktri.POOL_RANK_BINS
    assert const("kScalars") + const("kThreads") // 32 == ktri.POOL_RANK_WORDS
    assert const("kMaxB") == ktri.MAX_NEIGHBORS


# -- the kernel on the card -----------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(name):
    """The kernel's pool is the plain version's on the card, bit for bit, and
    the rule's; its duplicate count is the plain mask's sum a pair; one
    launch a call."""
    c = CASES[name]()
    args = _args(c, "cuda")
    before = _build.launches()["pool_rank"]
    got = ktri.pool_rank(*args)
    assert _build.launches()["pool_rank"] == before + 1
    ref = ktri.pool_rank_reference(*args)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    want = brute_pool(c["anchors"], c["nbr_s"], c["nbr_idx"], c["cand"], c["K"], c["dedup"])
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
    if c["dedup"]:
        anchors, nbr_s, nbr_idx = args[:3]
        b1, b2 = ktri.pair_slots(nbr_idx.shape[2], "cuda")
        mask = ktri.mark_cross_anchor_duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2,
                                                 c["n_nodes"])
        assert torch.equal(ktri.DUPLICATES_MARKED[-1], mask.sum(dim=(1, 2)))


CELLS = {"threedmatch.sweep": ("threedmatch", "split1623"),
         "threedlomatch.sweep": ("threedlomatch", "split1781_nvalid"),
         "kitti.sweep": ("kitti", "batch64"),
         "kitti.masked": ("kitti", "batch64_nvalid")}


@needs_cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_pool_and_register_batch_keep_their_bits_on_card(cell, monkeypatch):
    """On a cell's first batch (N = 2,048; 2,500 masked U[1,000, 2,500];
    50,000 unmasked and masked), inside `register_batch`: the kernel's pool
    equals the plain version's on the same inputs, with `torch.equal`, its
    duplicate count the plain mask's sum; and `register_batch` gives the
    bits it gives with the plain ranking in place of the kernel, the
    composition the kernel replaced."""
    from regbench import generate
    from saccot_tpu_torch.engine.sac_cot import register_batch
    from saccot_tpu_torch.utils.params import SacCotParams

    config, traffic = CELLS[cell]
    cfg = json.loads((REPO / "regbench" / "configs" / f"{config}.json").read_text())
    trf = json.loads((REPO / "regbench" / "traffic" / f"{traffic}.json").read_text())
    trf = dict(trf, distinct_batches=1)
    P, Q, _, mask = generate.cell_batches(24, cfg, trf)[0]
    params = SacCotParams(**cfg["params"])
    kernel, seen = ktri.pool_rank, []

    def both(*args):
        got = kernel(*args)
        seen.append((got, ktri.pool_rank_reference(*args), args))
        return got

    monkeypatch.setattr(ktri, "pool_rank", both)
    res = register_batch(P, Q, params, mask=mask)
    (got, ref, args), = seen
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert got[0].shape == (P.shape[0], params.max_hypotheses, 3)
    anchors, nbr_s, nbr_idx = args[:3]
    b1, b2 = ktri.pair_slots(nbr_idx.shape[2], "cuda")
    dup = ktri.mark_cross_anchor_duplicates(anchors, nbr_idx, nbr_s > 0, b1, b2, args[6])
    assert torch.equal(ktri.DUPLICATES_MARKED[-1], dup.sum(dim=(1, 2)))
    monkeypatch.setattr(ktri, "pool_rank", ktri.pool_rank_reference)
    old = register_batch(P, Q, params, mask=mask)
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(old, f)), f
