"""The port's file modes against the JAX package's: `files`, `sequence`
(with and without loop closure), `external` and `ablate` through the port's
`main([..., "--cpu"])` in this process, on files written to `tmp_path`, and
the fault-injected sweep resumed from its checkpoint in two subprocesses.

The JAX side runs `register_files`, `run_sequence_files` and
`run_external` on the same files, its pipeline entry points op by op
(see tests/test_torch_cli.py). The sequence mode runs at max_pts=2000,
bucket=2048 (as tests/test_io.py does) and a budget of 2,048 points after
the voxel grid (`max_cloud_points`; every voxel of a 2,000-point scan
fits), and the external mode with the small estimator of
tests/test_cli_external.py, both set by wrapping the mode's function as
that test does.

Held: the same success, recall and loop counts; T (and each trajectory
pose) within 0.1 degrees and 1e-3 of the JAX package's
(tests/test_torch_pipeline.py's tolerance); keypoint and correspondence
counts within 2 (its tolerance: XLA's and torch's `acos`/`cos` can flip an
NMS decision at an ulp-sized tie). The ablation holds saccot's recall
equal to the JAX package's and the ordering saccot >= edge >= random (the
random draws are the port's own).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from saccot_tpu.cli import external as jexternal
from saccot_tpu.cli import files as jfiles
from saccot_tpu.cli import sequence as jsequence
from saccot_tpu.cli.configs import _OBJ_PARAMS as J_OBJ
from saccot_tpu.evaluation.ablation import run_sampler_ablation as jrun_sampler_ablation
from saccot_tpu.utils.params import SacCotParams as JSacCotParams
from saccot_tpu_torch.cli import external, sequence
from saccot_tpu_torch.cli.configs import _OBJ_PARAMS
from saccot_tpu_torch.io.external import save_descriptors_npz
from saccot_tpu_torch.io.loaders import load_gt_log
from saccot_tpu_torch.io.synthetic import blob_cloud, two_view_pair
from saccot_tpu_torch.utils import se3np
from saccot_tpu_torch.utils.params import SacCotParams
from torch_cli_common import assert_T_close, jax_op_by_op, run_main

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def write_ply(path, pts):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
    )
    path.write_bytes(header.encode() + pts.astype("<f4").tobytes())


def test_files_mode_matches_jax(tmp_path, monkeypatch, capsys):
    pair = two_view_pair(seed=41, n_points=1000, overlap=0.85, noise=0.002)
    write_ply(tmp_path / "src.ply", pair["source"])
    write_ply(tmp_path / "tgt.ply", pair["target"])
    np.savetxt(tmp_path / "gt.txt", pair["T_gt"])
    args = ["--src", str(tmp_path / "src.ply"), "--tgt", str(tmp_path / "tgt.ply"),
            "--gt", str(tmp_path / "gt.txt")]
    got = run_main(["files"] + args, capsys)
    jax_op_by_op(monkeypatch, jfiles)
    want = jfiles.register_files(*args[1:4:2], gt_path=args[5])
    assert set(got) == set(want)
    assert got["success"] and got["success"] == want["success"]
    assert got["rot_err_deg"] < 5.0 and got["bucket"] == want["bucket"] == 1024
    assert got["points"] == list(want["points"])
    for key in ("num_correspondences",):
        assert abs(got[key] - want[key]) <= 2, key
    assert all(abs(a - b) <= 2 for a, b in zip(got["num_keypoints"], want["num_keypoints"]))
    assert_T_close(got["T"], want["T"], "files")


def write_sequence(path, loop):
    """KITTI .bin scans of one blob from a trajectory, and its poses.txt: 4
    scans on an open path, or 6 on a circle that returns to the start."""
    rng = np.random.default_rng(17 if loop else 7)
    world = blob_cloud(rng, 1500).astype(np.float64)
    if loop:
        poses = []
        for a in np.linspace(0, 2 * np.pi, 6):
            T = np.eye(4)
            T[:3, :3] = se3np.exp_so3(np.array([0.0, 0.0, a * 0.05]))
            T[0, 3] = np.cos(a) * 0.12 - 0.12
            T[1, 3] = np.sin(a) * 0.12
            poses.append(T)
    else:
        poses = [np.eye(4)]
        for _ in range(3):
            poses.append(poses[-1] @ se3np.random_transform(rng, max_angle_rad=0.15,
                                                            max_trans=0.08))
    for i, pose in enumerate(poses):
        scan = se3np.apply_T(np.linalg.inv(pose), world)
        scan = scan + rng.normal(scale=0.002, size=scan.shape)
        raw = np.concatenate([scan, np.zeros((len(scan), 1))], axis=1)
        raw.astype("<f4").tofile(path / f"{i:06d}.bin")
    np.savetxt(path / "poses.txt", np.stack([p[:3, :].reshape(-1) for p in poses]))
    return len(poses)


@pytest.mark.parametrize("loop", [False, True], ids=["odometry", "loops"])
def test_sequence_mode_matches_jax(tmp_path, monkeypatch, capsys, loop):
    n_scans = write_sequence(tmp_path, loop)
    small = dict(max_pts=2000, bucket=2048, loop_min_gap=3, loop_min_inliers=10)
    full = {}

    def port(path, **kw):
        cfg = dataclasses.replace(sequence.default_sequence_config(metric_scale=0.05),
                                  max_cloud_points=2048)
        out = sequence_run(path, cfg=cfg, **small, **kw)
        full.update(out)
        return out

    sequence_run = sequence.run_sequence_files
    monkeypatch.setattr(sequence, "run_sequence_files", port)
    cli = ["sequence", "--dir", str(tmp_path), "--poses", str(tmp_path / "poses.txt")]
    got = run_main(cli + (["--loops"] if loop else []), capsys)
    jax_op_by_op(monkeypatch, jsequence)
    want = jsequence.run_sequence_files(
        str(tmp_path), fmt="kitti", poses_path=str(tmp_path / "poses.txt"),
        cfg=dataclasses.replace(jsequence.default_sequence_config(metric_scale=0.05),
                                max_cloud_points=2048),
        loops=loop, **small)
    assert "trajectory" not in got and set(got) | {"trajectory"} == set(want)
    assert got["scans"] == want["scans"] == n_scans and got["pairs"] == n_scans - 1
    assert got["native_prefetch"] == want["native_prefetch"]
    assert got["mean_rot_err_deg"] < 3.0 and got["ate_rmse"] < 0.1, got
    for k, (a, b) in enumerate(zip(full["trajectory"], want["trajectory"])):
        T_a, T_b = np.eye(4), np.eye(4)
        T_a[:3] = np.reshape(a, (3, 4))
        T_b[:3] = np.reshape(b, (3, 4))
        assert_T_close(T_a, T_b, f"pose {k}")
    np.testing.assert_allclose(got["ate_rmse"], want["ate_rmse"], rtol=0.05, atol=1e-4)
    if loop:
        for key in ("loop_candidates", "loop_closures"):
            assert got[key] == want[key], key
        assert got["loop_closures"] >= 1
        assert got["ate_rmse_optimized"] <= got["ate_rmse"] * 1.2 + 1e-4, got
        np.testing.assert_allclose(got["tls_gate"], want["tls_gate"], rtol=1e-3)


def write_scene(root, n_frag=4, n_world=600, n_keep=320, dim=32, seed=5):
    """tests/test_cli_external.py's scene: world points with persistent random
    descriptors, fragments = posed noisy subsets, gt.log = exact relative
    poses in the Redwood/3DMatch convention."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(-1.5, 1.5, size=(n_world, 3)).astype(np.float32)
    D = rng.normal(size=(n_world, dim)).astype(np.float32)
    frag_dir = root / "fragments"
    frag_dir.mkdir()
    poses = []
    for k in range(n_frag):
        T = se3np.random_transform(rng, max_angle_rad=0.8, max_trans=0.5)
        poses.append(T)
        idx = np.sort(rng.choice(n_world, size=n_keep, replace=False))
        x = se3np.apply_T(se3np.inv_T(T), W[idx]).astype(np.float32)
        x += rng.normal(scale=0.003, size=x.shape).astype(np.float32)
        d = (D[idx] + rng.normal(scale=0.05, size=(n_keep, dim))).astype(np.float32)
        save_descriptors_npz(str(frag_dir / f"cloud_bin_{k}.npz"), x, d)
    pairs = [(i, i + 1) for i in range(n_frag - 1)] + [(0, n_frag - 1)]
    gt_path = root / "gt.log"
    with open(gt_path, "w") as f:
        for (i, j) in pairs:
            T_ij = se3np.inv_T(poses[i]) @ poses[j]
            f.write(f"{i} {j} {n_frag}\n")
            for r in range(4):
                f.write(" ".join(f"{v:.9f}" for v in T_ij[r]) + "\n")
    return str(frag_dir), str(gt_path), pairs


SMALL = dict(compat_tau=0.05, min_separation=0.1, inlier_tau=0.05, num_anchors=128,
             neighbors_per_anchor=12, max_hypotheses=512, degree_block_rows=128)


def test_external_mode_matches_jax(tmp_path, monkeypatch, capsys):
    frag_dir, gt_path, pairs = write_scene(tmp_path)
    monkeypatch.setattr(external, "run_external",
                        functools.partial(external.run_external, params=SacCotParams(**SMALL),
                                          batch=4))
    log_path, est_path = tmp_path / "pairs.jsonl", tmp_path / "est.log"
    got = run_main(["external", "--dir", frag_dir, "--gt-log", gt_path, "--max-corr", "256",
                    "--log", str(log_path), "--out-log", str(est_path)], capsys)
    jest = tmp_path / "jest.log"
    want = jexternal.run_external(frag_dir, gt_path, params=JSacCotParams(**SMALL),
                                  max_correspondences=256, batch=4, out_log=str(jest))
    assert set(got) == set(want)
    assert got["n_pairs"] == want["n_pairs"] == len(pairs) and got["n_fragments"] == 4
    assert got["recall"] == want["recall"] == 1.0 and got["impl"] == "kernel"
    assert got["bucket"] == want["bucket"] == 512
    assert abs(got["mean_inliers"] - want["mean_inliers"]) <= 2
    records = [json.loads(ln) for ln in open(log_path)]
    assert len(records) == len(pairs) and all(r["registered"] for r in records)
    est, jest_T, gt = load_gt_log(str(est_path)), load_gt_log(str(jest)), load_gt_log(gt_path)
    assert set(est) == set(gt) == set(jest_T)
    for key in gt:
        assert_T_close(est[key], jest_T[key], f"pair {key}")
        E = est[key] @ np.linalg.inv(gt[key])
        assert se3np.rotation_angle_deg(E[:3, :3]) < 2.0 and np.linalg.norm(E[:3, 3]) < 0.05


def test_ablate_mode_matches_jax(capsys):
    got = run_main(["ablate", "--pairs", "4", "--corr", "256", "--outliers", "0.85",
                    "--budget", "128"], capsys)
    assert got["budget"] == 128 and set(got["recall"]) == {"random", "edge", "saccot"}
    r = {s: row["0.85"] for s, row in got["recall"].items()}
    assert r["saccot"] >= r["edge"] >= r["random"], r
    want = jrun_sampler_ablation(dataclasses.replace(J_OBJ, max_hypotheses=128),
                                 outlier_ratios=(0.85,), n_pairs=4, n_corr=256,
                                 samplers=("saccot",), impl="jnp")
    assert r["saccot"] == want["recall"]["saccot"][0.85]
    assert dataclasses.asdict(_OBJ_PARAMS) == dataclasses.asdict(J_OBJ)


def test_fault_injected_sweep_resumes(tmp_path, capsys):
    """The sweep exits with code 17 after checkpointing shard 0; a rerun with
    the same --ckpt resumes from shard 1 and ends with the uninterrupted
    run's recall."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    ckpt = tmp_path / "ck"
    args = [sys.executable, "-m", "saccot_tpu_torch.cli.main", "threedmatch", "--cpu",
            "--pairs", "32", "--corr", "256", "--ckpt", str(ckpt)]
    first = subprocess.run(args + ["--fail-after-shard", "0"], capture_output=True, text=True,
                           timeout=300, env=env, cwd=REPO)
    assert first.returncode == 17, (first.returncode, first.stderr[-2000:])
    assert sorted(p.name for p in ckpt.iterdir()) == ["shard_000000.npz"]
    second = subprocess.run(args, capture_output=True, text=True, timeout=300, env=env,
                            cwd=REPO)
    assert second.returncode == 0, second.stderr[-2000:]
    resumed = json.loads(second.stdout.strip().splitlines()[-1])
    assert resumed["pairs"] == 32 and resumed["recall"] > 0.9
    assert sorted(p.name for p in ckpt.iterdir()) == ["shard_000000.npz", "shard_000001.npz"]
    whole = run_main(["threedmatch", "--pairs", "32", "--corr", "256"], capsys)
    for key in ("recall", "mean_rot_err_deg", "mean_trans_err"):
        assert resumed[key] == whole[key], key
