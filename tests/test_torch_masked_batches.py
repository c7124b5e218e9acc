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
