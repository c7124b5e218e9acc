"""Matcher-filtered, padded correspondence batches through `register_batch`.

At the `threedlomatch` configuration's route (a padded N above the two-sided
degree kernel's 2,048 and up to the fused anchor kernel's 4,096: the
triangle degrees, the masked fused anchor kernel and the dedup pool), both
routes of the estimator give the benchmark's plain reference on seeded
problems of its generator, field for field. A masked call keeps each pair's
valid count in `sac_cot.VALID_COUNTS` (at most `VALID_COUNTS_KEPT` calls);
an unmasked call keeps nothing. On the card (skipped here: it needs a CUDA
device) the kernel route holds the reference to the cell's limits, and the
recording alone runs under `torch.cuda.set_sync_debug_mode("error")`.

The symmetric degree kernel skips the tile pairs a mask leaves with no valid
row or column: T (T + 1) / 2 - k (k + 1) / 2 of T tiles of 128 with k
holding a valid entry (checked here on hand-made masks against the tile
pairs counted one by one). On the card, under padding at the end, an empty
pair, an all-valid and a scattered mask at N = 2,500 and 50,000, its degrees
are the bits of the same call cut after the last valid tile, the plain
version's to the degree tolerance, zero at every masked entry, and the count
it keeps in `compat_k.TILE_PAIRS_SKIPPED` is that number.
"""

import json
from pathlib import Path

import pytest
import torch

from regbench import compare, generate
from regbench.reference import saccot as reference
from saccot_tpu_torch.engine import sac_cot
from saccot_tpu_torch.kernels import compat as compat_k
from saccot_tpu_torch.kernels import triangles as tri_k
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = json.loads((REPO / "regbench" / "configs" / "threedlomatch.json").read_text())
LIMITS = json.loads((REPO / "regbench" / "workloads" / "threedlomatch.sweep.json")
                    .read_text())["limits"]
PRM = dict(CFG["params"], num_anchors=24, max_hypotheses=64)
N, N_VALID = 2500, (2100, 2500)
SMALL = SacCotParams(compat_tau=0.05, min_separation=0.1, inlier_tau=0.05, num_anchors=8,
                     neighbors_per_anchor=6, max_hypotheses=16)
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernels have no CPU mode")


def _problems(device, pairs=2, n=N, n_valid=N_VALID, seed=2 ** 31 + 55):
    gen = torch.Generator(device=device).manual_seed(seed)
    return generate.planted_batch(gen, pairs, n, CFG["problem"], n_valid=n_valid,
                                  device=device)


def test_the_configuration_takes_the_route_between_the_splits():
    assert compat_k.TRI_MIN_ROWS < N_VALID[0] <= N <= tri_k.MAX_N_FUSED
    assert CFG["n"] == N


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_a_masked_batch_gives_the_reference(impl):
    P, Q, _, mask = _problems("cpu")
    assert not mask.all() and (mask.sum(1) >= N_VALID[0]).all()
    res = sac_cot.register_batch(P, Q, SacCotParams(**PRM), mask=mask, impl=impl)
    got = {f: getattr(res, f).numpy() for f in compare.FIELDS}
    ref = compare.run_reference(reference.register, P, Q, mask, PRM, block=2)
    assert compare.gaps(got, ref) == dict.fromkeys(compare.NUMBERS, 0.0)
    assert res.success.all() and not (res.inliers & ~mask).any()


@needs_cuda
def test_a_masked_batch_on_the_card_holds_the_cell_s_limits():
    torch.backends.cuda.matmul.allow_tf32 = False
    P, Q, _, mask = _problems("cuda", pairs=8, n_valid=(1000, 2500))
    res = sac_cot.register_batch(P, Q, SacCotParams(**PRM), mask=mask, impl="kernel")
    got = {f: getattr(res, f).cpu().numpy() for f in compare.FIELDS}
    ref = compare.run_reference(reference.register, P, Q, mask, PRM, block=8)
    assert compare.judge(compare.gaps(got, ref), LIMITS), compare.gaps(got, ref)


def _masked_calls(calls):
    P, Q, _, mask = _problems("cpu", pairs=3, n=60, n_valid=(30, 60))
    for _ in range(calls):
        sac_cot.register_batch(P, Q, SMALL, mask=mask)
    return mask


def test_a_masked_call_records_its_valid_counts():
    sac_cot.VALID_COUNTS.clear()
    mask = _masked_calls(2)
    assert len(sac_cot.VALID_COUNTS) == 2
    for rec in sac_cot.VALID_COUNTS:
        assert rec.n_valid.dtype == torch.int64 and rec.local is False
        assert torch.equal(rec.n_valid, mask.sum(1))


def test_an_unmasked_call_records_nothing():
    sac_cot.VALID_COUNTS.clear()
    P, Q = _problems("cpu", pairs=2, n=60, n_valid=None)[:2]
    for impl in ("kernel", "plain"):
        sac_cot.register_batch(P, Q, SMALL, impl=impl)
    assert len(sac_cot.VALID_COUNTS) == 0


def test_the_store_keeps_only_its_bound():
    sac_cot.VALID_COUNTS.clear()
    mask = _masked_calls(3)
    kept = sac_cot.VALID_COUNTS_KEPT
    for i in range(kept):
        sac_cot._record_valid_counts(torch.ones((1, i + 1), dtype=torch.bool), local=False)
    assert len(sac_cot.VALID_COUNTS) == kept
    # The oldest went first: the three estimator calls are gone, the newest is last.
    assert [int(r.n_valid[0]) for r in sac_cot.VALID_COUNTS] == list(range(1, kept + 1))
    sac_cot.register_batch(*_problems("cpu", pairs=3, n=60, n_valid=(30, 60))[:2], SMALL,
                           mask=mask)
    assert len(sac_cot.VALID_COUNTS) == kept
    assert torch.equal(sac_cot.VALID_COUNTS[-1].n_valid, mask.sum(1))
    assert int(sac_cot.VALID_COUNTS[0].n_valid[0]) == 2


@needs_cuda
def test_recording_on_the_card_syncs_nothing():
    mask = torch.arange(300, device="cuda")[None, :] < torch.tensor([[120], [300]],
                                                                     device="cuda")
    sac_cot.VALID_COUNTS.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sac_cot._record_valid_counts(mask, local=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rec = sac_cot.VALID_COUNTS[-1]
    assert rec.n_valid.is_cuda and rec.n_valid.tolist() == [120, 300]


# -- the symmetric degree kernel's empty tile pairs --------------------------

TILE = 128


def _layout_mask(layout, n, device):
    """A [2, n] float mask: "tail" keeps a first n_b of each pair (never a
    whole number of tiles), "empty_pair" keeps nothing of pair 0 and a tail
    of pair 1, "all_valid" everything, "every_7th" all but every 7th entry."""
    ids = torch.arange(n, device=device)
    keep = {2500: (2177, 2090), 50000: (41001, 30001)}[n]
    if layout == "tail":
        return (ids[None] < torch.tensor(keep, device=device)[:, None]).float()
    if layout == "empty_pair":
        return (ids[None] < torch.tensor((0, keep[0]), device=device)[:, None]).float()
    mask = torch.ones((2, n), device=device)
    if layout == "every_7th":
        mask[:, ::7] = 0
    return mask


def _skipped_by_formula(mask):
    """T (T + 1) / 2 - k (k + 1) / 2 per pair: T tiles of 128, k of them
    holding a nonzero mask entry."""
    batch, n = mask.shape
    n_tiles = -(-n // TILE)
    valid = torch.nn.functional.pad(mask.cpu() != 0, (0, n_tiles * TILE - n))
    k = valid.view(batch, n_tiles, TILE).any(dim=2).sum(dim=1)
    return (n_tiles * (n_tiles + 1) // 2 - k * (k + 1) // 2).tolist()


def _skipped_by_tiles(mask):
    """The tile pairs (ti <= tj) with no valid row in ti or no valid column
    in tj, counted one by one."""
    n_tiles = -(-mask.shape[1] // TILE)
    out = []
    for row in mask.cpu():
        valid = [bool(row[t * TILE:(t + 1) * TILE].any()) for t in range(n_tiles)]
        out.append(sum(not (valid[ti] and valid[tj])
                       for ti in range(n_tiles) for tj in range(ti, n_tiles)))
    return out


def _from_tiles(n, tiles, batch=1):
    """A [batch, n] mask whose valid entries are the given tiles' first."""
    mask = torch.zeros((batch, n))
    for t in tiles:
        mask[:, t * TILE] = 1.0
    return mask


@pytest.mark.parametrize("mask, expected", [
    (torch.zeros((1, 300)), [6]),
    (torch.ones((1, 300)), [0]),
    (_from_tiles(300, [1]), [5]),
    (_from_tiles(300, [0, 2]), [3]),
    ((torch.arange(300) < 129).float()[None], [3]),
    ((torch.arange(300) % 7 != 0).float()[None], [0]),
    ((torch.arange(2500) < 2177).float()[None], [39]),
    ((torch.arange(50000) < 25000).float()[None], [76636 - 19306]),
    (torch.stack([torch.zeros(300), torch.ones(300)]), [6, 0]),
    (torch.tensor([[0.0, 0.5, -1.0]]), [0]),
], ids=["none", "all", "one_tile", "two_scattered_tiles", "tail_129", "every_7th",
        "tail_2177_of_2500", "half_of_50000", "two_pairs", "nonzero_not_one"])
def test_the_skipped_tile_pairs_follow_the_mask(mask, expected):
    assert _skipped_by_formula(mask) == expected == _skipped_by_tiles(mask)


def test_the_plain_degrees_keep_no_skip_count():
    P, Q, _, mask = _problems("cpu", pairs=2, n=300, n_valid=(100, 200))
    compat_k.TILE_PAIRS_SKIPPED.clear()
    compat_k.degrees_tri(P, Q, SMALL, mask=mask.float())
    assert len(compat_k.TILE_PAIRS_SKIPPED) == 0


def _tri_case(n):
    """Two pairs at N = n on the card with their parameters: the 3DLoMatch
    generator at 2,500, the kitti problems at 50,000."""
    if n == 50000:
        P, Q, _ = kitti_problem_batch([KITTI_SEED, KITTI_SEED + 1], device="cuda", n=n)
        return P, Q, KITTI_PARAMS
    P, Q = _problems("cuda", pairs=2, n=n, n_valid=None)[:2]
    return P, Q, SacCotParams(**PRM)


@needs_cuda
@pytest.mark.parametrize("layout", ["tail", "empty_pair", "all_valid", "every_7th"])
@pytest.mark.parametrize("n", [2500, 50000])
def test_empty_tile_pairs_are_skipped_to_the_same_bits_on_the_card(n, layout):
    P, Q, params = _tri_case(n)
    mask = _layout_mask(layout, n, "cuda")
    compat_k.TILE_PAIRS_SKIPPED.clear()
    deg = compat_k.degrees_tri(P, Q, params, mask=mask)
    skipped = compat_k.TILE_PAIRS_SKIPPED[-1]
    # Cut after the last valid tile: the tiles beyond add only +0.0, in order.
    last = int((mask != 0).any(dim=0).nonzero().max()) + 1
    cut = min(n, -(-last // TILE) * TILE)
    assert cut > compat_k.TRI_MIN_ROWS
    part = compat_k.degrees_tri(P[:, :cut].contiguous(), Q[:, :cut].contiguous(), params,
                                mask=mask[:, :cut].contiguous())
    assert torch.equal(deg[:, :cut], part) and not deg[:, cut:].any()
    ref = compat_k.degrees_reference(P, Q, P, Q, params, mask_rows=mask, mask_cols=mask)
    torch.testing.assert_close(deg, ref, rtol=1e-5, atol=2e-3)
    assert not deg.isnan().any() and not deg[mask == 0].any()
    assert skipped.dtype == torch.int64 and skipped.tolist() == _skipped_by_formula(mask)


@needs_cuda
def test_an_unmasked_launch_keeps_no_skip_count_and_a_masked_one_syncs_nothing():
    P, Q, params = _tri_case(2500)
    mask = _layout_mask("tail", 2500, "cuda")
    compat_k.degrees_tri(P, Q, params, mask=mask)   # builds the library
    compat_k.TILE_PAIRS_SKIPPED.clear()
    compat_k.degrees_tri(P, Q, params)
    assert len(compat_k.TILE_PAIRS_SKIPPED) == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        compat_k.degrees_tri(P, Q, params, mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert compat_k.TILE_PAIRS_SKIPPED[-1].is_cuda
