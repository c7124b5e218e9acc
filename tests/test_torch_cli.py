"""The port's command line against the JAX package's runners: the five run
configurations at small sizes through `main([..., "--cpu"])` in this
process, the refusal to run without a card unless --cpu is given, and
`measure_scaling` on the one-rank mesh (and on two gloo ranks).

Each configuration runs through the port's `main` and through
`saccot_tpu.cli.runners.run_config` with the same overrides, so both make
the same inputs from the same seeds. Each pair's (or the trajectory's)
transforms are read from the argument the runner hands its criterion
(`registration_error`, `model_rmse`, `ate`). The JAX runners' pipeline
entry points run op by op (`_register_clouds` and the `__wrapped__` bodies
of the scan-feature functions), as tests/test_torch_pipeline.py runs them:
a jitted JAX program fuses multiply-adds and moves its own keypoint counts.

Held: the same metric keys; recall (and, for u3m, each pair's criterion
outcome and the eligible-pair and band counts) equal; each pair's T within
0.1 degrees and 1e-3 of the JAX package's (tests/test_torch_pipeline.py's
tolerance; the estimator-only configurations stay far inside it: the same
correspondences, the refine's sums in another order); slam's edges
registered and BA track counts equal, every pose within 1e-4 and the ATEs
within rtol 1e-3 (tests/test_torch_slam_sequence.py holds poses within
1e-4 where well observed; at 4 scans the poses agree within 2e-7).
"""

import dataclasses

import numpy as np
import pytest
import torch

from saccot_tpu.cli import runners as jrunners
from saccot_tpu.cli.configs import CONFIGS as JCONFIGS
from saccot_tpu_torch.cli import runners
from saccot_tpu_torch.cli.main import main
from saccot_tpu_torch.evaluation.scaling import measure_scaling
from saccot_tpu_torch.utils.params import SacCotParams
from torch_cli_common import assert_T_close, jax_op_by_op, run_main

torch.set_num_threads(2)



def spy(monkeypatch, module, name):
    """Record (first argument as float64, result) of every call of module.name."""
    calls = []
    orig = getattr(module, name)

    def rec(*a, **k):
        out = orig(*a, **k)
        calls.append((np.asarray(a[0], np.float64), out))
        return out

    monkeypatch.setattr(module, name, rec)
    return calls


# config: (CLI overrides, RunConfig overrides, the criterion the runner hands T)
CASES = {
    "slam": (["--scans", "4", "--corr", "128"], dict(n_scans=4, n_corr=128), "ate"),
    "threedmatch": (["--pairs", "4", "--corr", "256"], dict(n_pairs=4, n_corr=256),
                    "registration_error"),
    "u3m": (["--views", "5"], dict(n_views=5), "model_rmse"),
    "bunny": (["--pairs", "1"], dict(n_pairs=1), "registration_error"),
    # N > 4096: the symmetric degrees and the streamed pool (plain versions)
    "kitti": (["--pairs", "1", "--corr", "5000"], dict(n_pairs=1, n_corr=5000),
              "registration_error"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_config_matches_jax_runner(name, monkeypatch, capsys):
    cli, over, criterion = CASES[name]
    got_calls = spy(monkeypatch, runners, criterion)
    want_calls = spy(monkeypatch, jrunners, criterion)
    jax_op_by_op(monkeypatch, jrunners)
    got = run_main([name] + cli, capsys)
    want = jrunners.run_config(dataclasses.replace(JCONFIGS[name], **over))
    assert set(got) == set(want)
    assert got["config"] == name and len(got_calls) == len(want_calls) > 0
    if name == "slam":
        for key in ("scans", "edges", "edges_registered", "ba_tracks", "ba_multiview_tracks",
                    "ba_obs_truncated"):
            assert got[key] == want[key], key
        assert got["edges_registered"] == got["edges"] == 5
        for key in ("ate_rmse", "ate_rmse_pgo"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3)
        for (a, _), (b, _) in zip(got_calls, want_calls):   # PGO, then final poses
            np.testing.assert_allclose(a, b, atol=1e-4)
        return
    assert got["recall"] == want["recall"]
    for key in ("pairs", "eligible_pairs", "pairs_by_overlap_band", "recall_all_pairs",
                "recall_by_overlap_band", "n_corr"):
        assert got.get(key) == want.get(key), key
    for k, ((T_a, out_a), (T_b, out_b)) in enumerate(zip(got_calls, want_calls)):
        assert_T_close(T_a, T_b, f"{name} pair {k}")
        if criterion == "model_rmse":
            np.testing.assert_allclose(out_a, out_b, rtol=1e-3, atol=1e-6)


def test_main_without_card_names_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["slam"]) != 0
    err = capsys.readouterr().err
    assert "--cpu" in err and "CUDA" in err


@pytest.mark.parametrize("counts", [[1], [1, 2]])
def test_measure_scaling(counts):
    """Size 1 on the one-rank mesh in this process, size 2 on two spawned
    gloo ranks (a check of the mechanics, not a scaling reading); the keys
    of the JAX harness's result (`saccot_tpu/evaluation/scaling.py`)."""
    got = measure_scaling(SacCotParams(num_anchors=32, neighbors_per_anchor=8,
                                       max_hypotheses=64),
                          n_corr=128, pairs_per_device=2, reps=1, device_counts=counts,
                          device="cpu", backend="gloo")
    assert set(got) == {"pairs_per_sec", "efficiency", "device_counts"}
    assert got["device_counts"] == counts and list(got["pairs_per_sec"]) == counts
    assert all(v > 0 for v in got["pairs_per_sec"].values())
    assert got["efficiency"][1] == 1.0


needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kitti kernels have no CPU mode")


@pytest.mark.parametrize("device,n", [("cpu", 5000), pytest.param("cuda", 50000,
                                                                   marks=needs_cuda)])
def test_kitti_pair_alone_matches_its_batch(device, n, monkeypatch):
    """The kitti runner registers each pair alone (`register_pair`); the chip
    script's phase 7 registers both in one batch. Every stage (degrees,
    pool, solve, scores, the refine) gives a pair the same bits alone as in
    the batch: on the card the refine kernel sums in an order fixed by N
    alone. On the CPU the plain refine's inlier masks are the same bits, and
    its weighted sums over N rows (`umeyama`, torch reductions) may add in
    another order for one row than for two: its fits, R, t and T within
    1e-5 there."""
    from saccot_tpu_torch import register_batch
    from saccot_tpu_torch.engine import score as score_mod, triangles as tri_mod
    from saccot_tpu_torch.kernels import compat, score, solve3
    from saccot_tpu_torch.kernels import refine as krefine
    from saccot_tpu_torch.utils.convert import KITTI_PARAMS, kitti_problem_batch

    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in flat(y)]

    def recorder(fn, calls):
        def rec(*a, **k):
            out = fn(*a, **k)
            calls.append(flat(out))
            return out
        return rec

    stages = [(compat, "degrees"), (tri_mod, "triangle_pool_from_points"), (solve3, "solve3"),
              (score, "score_hypotheses"), (krefine, "refine")]
    if device == "cpu":   # the plain refine's own steps
        stages += [(krefine, "umeyama"), (score_mod, "inlier_mask")]
    calls = {}
    for mod, name in stages:
        calls[name] = []
        monkeypatch.setattr(mod, name, recorder(getattr(mod, name), calls[name]))
    P, Q, _ = kitti_problem_batch([500, 501], device=device, n=n)
    whole_T = register_batch(P, Q, KITTI_PARAMS).T
    whole = {name: list(c) for name, c in calls.items()}
    tol = 1e-5 if device == "cpu" else 0.0
    for b in range(2):
        for c in calls.values():
            c.clear()
        alone_T = register_batch(P[b:b + 1], Q[b:b + 1], KITTI_PARAMS).T
        for name, c in calls.items():
            assert len(c) == len(whole[name]) > 0, name
            for got, want in zip(c, whole[name]):
                for x, y in zip(got, want):
                    if name in ("refine", "umeyama") and x.is_floating_point():
                        assert (x[0] - y[b]).abs().max().item() <= tol
                    else:
                        assert torch.equal(x[0], y[b]), name
        assert (alone_T[0] - whole_T[b]).abs().max().item() <= tol
