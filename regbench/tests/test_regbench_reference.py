"""The plain reference gives the program's plain route, field for field, on
both routes of the exact pool: the fused and the streamed anchor rows (N up
to 4,096 and above), with and without a mask; and it refuses the settings
it does not compute."""

import pytest
import torch

from regbench import compare, generate, harness
from regbench.reference import saccot as reference

ROUTES = {"fused": 600, "streamed": 4200}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_reference_is_the_program_s_plain_route(route, masked):
    from saccot_tpu_torch.engine.sac_cot import register_batch
    from saccot_tpu_torch.utils.params import SacCotParams

    n = ROUTES[route]
    cfg = harness.load_cell("kitti.sweep").config
    prm = dict(cfg["params"], num_anchors=24, max_hypotheses=64)
    gen = torch.Generator().manual_seed(7)
    P, Q, _, mask = generate.planted_batch(gen, 2, n, cfg["problem"],
                                           n_valid=(n // 2, n) if masked else None,
                                           device="cpu")
    res = register_batch(P, Q, SacCotParams(**prm), mask=mask, impl="plain")
    got = {f: getattr(res, f).numpy() for f in compare.FIELDS}
    ref = compare.run_reference(reference.register, P, Q, mask, prm, block=2)
    assert compare.gaps(got, ref) == dict.fromkeys(compare.NUMBERS, 0.0)


@pytest.mark.parametrize("change", [dict(scoring="weighted"), dict(dedup_triangles=False),
                                    dict(per_anchor_candidates=4), dict(approx_topk=True),
                                    dict(ring_compat=True)])
def test_reference_refuses_what_it_does_not_compute(change):
    prm = dict(harness.load_cell("kitti.sweep").config["params"], **change)
    P = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError):
        reference.register(P, P, prm)
