"""The port's file I/O, checkpoints and logger (`io/loaders.py`,
`io/native.py`, `utils/checkpoint.py`, `utils/logging.py`), mirroring
tests/test_io.py on `tmp_path` files. Every reader is also held against the
JAX package's reader on the same file: equal arrays.
"""

import json

import numpy as np
import pytest
import torch

from saccot_tpu.io import loaders as jloaders
from saccot_tpu_torch.io import loaders, native
from saccot_tpu_torch.utils.checkpoint import (
    SweepCheckpointer, restore, save_slam_state,
)
from saccot_tpu_torch.utils.logging import JsonlLogger, is_host0


@pytest.fixture
def cloud(rng):
    return rng.normal(size=(100, 3)).astype(np.float32)


def _ply_header(fmt, n):
    return (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n")


def _write(kind, path, cloud):
    """Write `cloud` in one of the readers' formats; returns the file path and
    the tolerance its text or binary form keeps."""
    if kind == "ply_binary":
        path = path / "c.ply"
        path.write_bytes(_ply_header("binary_little_endian", len(cloud)).encode()
                         + cloud.astype("<f4").tobytes())
        return path, 1e-6
    if kind == "ply_ascii":
        path = path / "c.ply"
        body = "\n".join(" ".join(f"{v:.6f}" for v in row) for row in cloud)
        path.write_text(_ply_header("ascii", len(cloud)) + body + "\n")
        return path, 1e-5
    if kind == "pcd_binary":
        path = path / "c.pcd"
        header = (
            "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            f"COUNT 1 1 1\nWIDTH {len(cloud)}\nHEIGHT 1\n"
            f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(cloud)}\nDATA binary\n"
        )
        path.write_bytes(header.encode() + cloud.astype("<f4").tobytes())
        return path, 1e-6
    if kind == "kitti_bin":
        path = path / "scan.bin"
        raw = np.concatenate([cloud, np.zeros((len(cloud), 1), np.float32)], axis=1)
        raw.astype("<f4").tofile(path)
        return path, 1e-6
    if kind == "npy":
        path = path / "c.npy"
        np.save(path, cloud)
        return path, 0.0
    path = path / "c.xyz"
    np.savetxt(path, cloud)
    return path, 1e-6


@pytest.mark.parametrize("kind", ["ply_binary", "ply_ascii", "pcd_binary", "kitti_bin", "npy",
                                  "xyz"])
def test_reader_roundtrip_matches_jax(tmp_path, cloud, kind):
    path, atol = _write(kind, tmp_path, cloud)
    got = loaders.load_cloud(str(path))
    assert got.dtype == np.float32 and got.shape == cloud.shape
    np.testing.assert_allclose(got, cloud, atol=atol)
    np.testing.assert_array_equal(got, jloaders.load_cloud(str(path)))
    reader = {"ply": loaders.load_ply, "pcd": loaders.load_pcd,
              "kitti": loaders.load_kitti_bin}.get(kind.split("_")[0])
    if reader is not None:
        np.testing.assert_array_equal(reader(str(path)), got)


def test_kitti_bin_numpy_fallback_matches_native(tmp_path, cloud, monkeypatch):
    """Without the native library the NumPy reader gives the same array."""
    path, _ = _write("kitti_bin", tmp_path, cloud)
    want = loaders.load_kitti_bin(str(path))
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(loaders.load_kitti_bin(str(path)), want)
    np.testing.assert_allclose(want, cloud, atol=1e-6)


def test_kitti_poses(tmp_path):
    T = np.tile(np.eye(4), (3, 1, 1))
    T[1, :3, 3] = [1, 2, 3]
    path = tmp_path / "poses.txt"
    np.savetxt(path, T[:, :3, :].reshape(3, 12))
    got = loaders.load_kitti_poses(str(path))
    np.testing.assert_allclose(got, T, atol=1e-9)
    np.testing.assert_array_equal(got, jloaders.load_kitti_poses(str(path)))


def test_gt_log_and_save_log_roundtrip(tmp_path, rng):
    T = np.eye(4)
    T[:3, 3] = [0.5, -1.0, 2.0]
    lines = ["0 1 52"] + [" ".join(str(v) for v in row) for row in T]
    path = tmp_path / "gt.log"
    path.write_text("\n".join(lines) + "\n")
    got = loaders.load_gt_log(str(path))
    np.testing.assert_allclose(got[(0, 1)], T)
    assert got.keys() == jloaders.load_gt_log(str(path)).keys()
    # save_log writes what load_gt_log (both packages') reads back, and the
    # JAX package's save_log the same bytes.
    entries = {(0, 2): T, (1, 3): np.linalg.qr(rng.normal(size=(4, 4)))[0]}
    loaders.save_log(str(tmp_path / "a.log"), entries, n_fragments=4)
    jloaders.save_log(str(tmp_path / "b.log"), entries, n_fragments=4)
    assert (tmp_path / "a.log").read_bytes() == (tmp_path / "b.log").read_bytes()
    back = loaders.load_gt_log(str(tmp_path / "a.log"))
    assert set(back) == set(entries)
    for k in entries:
        np.testing.assert_allclose(back[k], entries[k], rtol=1e-7, atol=1e-12)


def test_pad_cloud_bucket(cloud):
    pts, mask = loaders.pad_cloud(cloud, 128)
    assert pts.shape == (128, 3) and mask.sum() == 100
    pts2, mask2 = loaders.pad_cloud(cloud, 64)
    assert pts2.shape == (64, 3) and mask2.sum() == 64
    for b in (128, 64):
        for a, j in zip(loaders.pad_cloud(cloud, b), jloaders.pad_cloud(cloud, b)):
            np.testing.assert_array_equal(a, j)
    assert loaders.bucket_for(100) == 1024
    assert loaders.bucket_for(5000) == 8192
    assert loaders.bucket_for(10 ** 6) == 65536


def test_native_prefetch_reader(tmp_path, rng):
    if not native.available():
        pytest.skip("native library not built or not loadable here")
    clouds = [rng.normal(size=(50 + 10 * i, 3)).astype(np.float32) for i in range(12)]
    paths = []
    for i, c in enumerate(clouds):
        p = tmp_path / f"{i:04d}.bin"
        raw = np.concatenate([c, np.zeros((len(c), 1), np.float32)], axis=1)
        raw.astype("<f4").tofile(p)
        paths.append(str(p))
    # Ordered delivery from a 4-thread pool with a small window.
    reader = native.prefetch_reader(paths, "kitti", max_pts=1000, threads=4, window=3)
    if reader is None:
        pytest.skip("prefetcher entry points missing from the library")
    with reader:
        got = list(reader)
    assert len(got) == len(clouds)
    for g, c in zip(got, clouds):
        np.testing.assert_allclose(g, c, atol=1e-6)
    # Unreadable files yield None without breaking the stream order.
    bad = native.prefetch_reader([paths[0], str(tmp_path / "nope.bin"), paths[1]],
                                 "kitti", max_pts=1000, threads=2, window=2)
    with bad:
        out = list(bad)
    assert out[1] is None
    np.testing.assert_allclose(out[0], clouds[0], atol=1e-6)
    np.testing.assert_allclose(out[2], clouds[1], atol=1e-6)
    np.testing.assert_array_equal(native.load_kitti_bin(paths[3]), clouds[3])


def test_sweep_checkpoint_resume(tmp_path):
    path = str(tmp_path / "ck")
    ck = SweepCheckpointer(path)
    assert not ck.is_done(0)
    ck.record(0, dict(T=np.eye(4)[None].repeat(4, 0)))
    ck.record(1, dict(T=2 * np.eye(4)[None].repeat(4, 0)))
    # A crash between the temporary write and the rename leaves a dot file.
    (tmp_path / "ck" / ".tmp_shard_000002.npz").write_bytes(b"partial")

    ck2 = SweepCheckpointer(path)
    assert ck2.is_done(0) and ck2.is_done(1) and not ck2.is_done(2)
    merged = ck2.merged()
    assert merged["T"].shape == (8, 4, 4)
    np.testing.assert_allclose(merged["T"][4], 2 * np.eye(4))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        ".tmp_shard_000002.npz", "shard_000000.npz", "shard_000001.npz"]

    (tmp_path / "file").write_text("x")
    with pytest.raises(ValueError, match="regular file"):
        SweepCheckpointer(str(tmp_path / "file"))
    # No path: progress held in memory only.
    ck3 = SweepCheckpointer(None)
    ck3.record(0, dict(T=np.zeros((1, 4, 4))))
    assert ck3.is_done(0)


def test_slam_state_checkpoint(tmp_path):
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[2, :3, 3] = [1, 2, 3]
    lm = np.arange(12, dtype=np.float32).reshape(4, 3)
    save_slam_state(str(tmp_path / "slam"), torch.as_tensor(poses), lm, gn_iter=3, lam=0.25)
    state = restore(str(tmp_path / "slam"))
    np.testing.assert_array_equal(state["poses"], poses)
    np.testing.assert_array_equal(state["landmarks"], lm)
    assert int(state["gn_iter"]) == 3 and float(state["lam"]) == 0.25
    assert restore(str(tmp_path / "absent")) is None


def test_jsonl_logger_numpy_and_tensor_values(tmp_path, capsys):
    assert is_host0()
    path = tmp_path / "sub" / "log.jsonl"
    with JsonlLogger(str(path)) as log:
        log.log(dict(a=np.int64(3), b=np.float32(0.5), c=np.arange(3),
                     d=torch.tensor([[1.5, 2.0]]), e=torch.tensor(7), f=(1, 2)))
        log.log(dict(ts=1.0, g=object))
    first, second = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert first["a"] == 3 and first["b"] == 0.5 and first["c"] == [0, 1, 2]
    assert first["d"] == [[1.5, 2.0]] and first["e"] == 7 and first["f"] == [1, 2]
    assert "ts" in first and second["ts"] == 1.0 and second["g"] == str(object)
    JsonlLogger().log(dict(x=np.float64(2.0)))  # the default stream is stderr
    assert json.loads(capsys.readouterr().err)["x"] == 2.0
