"""Point-cloud and ground-truth file loaders (host-side NumPy; port of
`saccot_tpu/io/loaders.py`).

PLY (ascii + binary little/big endian), PCD (ascii + binary), KITTI
velodyne `.bin`, KITTI pose files, and 3DMatch-style `gt.log` trajectories.
Pure-Python parsing into NumPy; the repository's C++ loader in `native/`
reads KITTI scans when its library loads (`io/native.py`), and the NumPy
reader takes over when it does not.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> np.ndarray:
    """Load vertex x/y/z from a PLY file -> [N, 3] float32."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: no PLY end_header")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elems: List[Tuple[str, int]] = []
    props: Dict[str, List[Tuple[str, str]]] = {}
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            elems.append((cur, int(parts[2])))
            props[cur] = []
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                props[cur].append(("list:" + parts[2] + ":" + parts[3], parts[4]))
            else:
                props[cur].append((parts[1], parts[2]))

    if fmt is None or not any(e[0] == "vertex" for e in elems):
        raise ValueError(f"{path}: malformed PLY header")
    n_vertex = dict(elems)["vertex"]
    vprops = props["vertex"]
    if any(t.startswith("list:") for t, _ in vprops):
        raise ValueError(f"{path}: list properties on vertex element unsupported")

    if fmt == "ascii":
        # Vertices are the first element in virtually all PLY files we care
        # about; parse the first n_vertex rows.
        rows = body.decode("ascii", errors="replace").split("\n")
        names = [n for _, n in vprops]
        out = np.empty((n_vertex, len(names)), np.float64)
        for i in range(n_vertex):
            out[i] = [float(v) for v in rows[i].split()[: len(names)]]
        arr = {n: out[:, j] for j, n in enumerate(names)}
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + _PLY_TYPES[t]) for t, n in vprops])
        arr = np.frombuffer(body, dtype=dtype, count=n_vertex)

    xyz = np.stack(
        [np.asarray(arr["x"], np.float32), np.asarray(arr["y"], np.float32),
         np.asarray(arr["z"], np.float32)], axis=1
    )
    return xyz


def load_pcd(path: str) -> np.ndarray:
    """Load x/y/z from a PCD (v0.7) file -> [N, 3] float32."""
    with open(path, "rb") as f:
        data = f.read()
    # Header is ascii lines until (and including) the DATA line.
    m = re.search(rb"DATA\s+(\S+)\n", data)
    if not m:
        raise ValueError(f"{path}: no PCD DATA line")
    header = data[: m.end()].decode("ascii", errors="replace")
    body = data[m.end():]
    fields: Dict[str, str] = {}
    for line in header.splitlines():
        parts = line.split()
        if parts:
            fields[parts[0].upper()] = parts[1:]
    names = fields["FIELDS"]
    sizes = [int(s) for s in fields["SIZE"]]
    types = fields["TYPE"]
    counts = [int(c) for c in fields.get("COUNT", ["1"] * len(names))]
    npts = int(fields["POINTS"][0])
    mode = fields["DATA"][0].lower()

    tmap = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
            ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
    if mode == "ascii":
        rows = body.decode("ascii", errors="replace").split()
        ncol = sum(counts)
        out = np.asarray([float(v) for v in rows[: npts * ncol]], np.float64).reshape(npts, ncol)
        col = 0
        arr = {}
        for n, c in zip(names, counts):
            arr[n] = out[:, col]
            col += c
    elif mode == "binary":
        dt = []
        for n, s, t, c in zip(names, sizes, types, counts):
            base = "<" + tmap[(t, s)]
            dt.append((n, base, (c,)) if c > 1 else (n, base))
        raw = np.frombuffer(body, dtype=np.dtype(dt), count=npts)
        arr = {n: np.asarray(raw[n]).reshape(npts, -1)[:, 0] for n in names}
    else:
        raise ValueError(f"{path}: PCD data mode {mode!r} unsupported (compressed?)")

    return np.stack(
        [np.asarray(arr["x"], np.float32), np.asarray(arr["y"], np.float32),
         np.asarray(arr["z"], np.float32)], axis=1
    )


def load_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: packed float32 x,y,z,reflectance -> [N, 3]."""
    from saccot_tpu_torch.io import native

    fast = native.load_kitti_bin(path) if native.available() else None
    if fast is not None:
        return fast
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return np.ascontiguousarray(raw[:, :3])


def load_cloud(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path)
    if ext == ".pcd":
        return load_pcd(path)
    if ext == ".bin":
        return load_kitti_bin(path)
    if ext in (".npy",):
        return np.load(path).astype(np.float32)[:, :3]
    if ext in (".txt", ".xyz"):
        return np.loadtxt(path, dtype=np.float32)[:, :3]
    raise ValueError(f"unsupported cloud format: {path}")


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry poses: rows of 12 floats (3x4 row-major) -> [M, 4, 4]."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    M = raw.shape[0]
    T = np.tile(np.eye(4), (M, 1, 1))
    T[:, :3, :4] = raw
    return T


def save_log(path: str, entries: Dict[Tuple[int, int], np.ndarray],
             n_fragments: int) -> None:
    """Write a 3DMatch/Redwood-style .log of estimated pair transforms.

    The standard interchange format consumed by the public 3DMatch /
    Redwood evaluation scripts: per pair a `i j n_fragments` header line
    followed by the 4x4 transform (fragment j -> fragment i's frame, the
    same direction `load_gt_log` reads). Counterpart of load_gt_log.
    """
    with open(path, "w") as f:
        for (i, j) in sorted(entries):
            T = np.asarray(entries[(i, j)], np.float64)
            f.write(f"{i}\t{j}\t{n_fragments}\n")
            for r in range(4):
                f.write("\t".join(f"{v:.8e}" for v in T[r]) + "\n")


def load_gt_log(path: str) -> Dict[Tuple[int, int], np.ndarray]:
    """3DMatch-style gt.log: blocks of `i j n` + 4 rows of 4 -> {(i,j): T}."""
    out: Dict[Tuple[int, int], np.ndarray] = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        ids = lines[i].split()
        a, b = int(ids[0]), int(ids[1])
        T = np.asarray([[float(v) for v in lines[i + r + 1].split()] for r in range(4)])
        out[(a, b)] = T
        i += 5
    return out


def pad_cloud(points: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate to a static bucket size with a validity mask.

    Sweep drivers round every cloud up to the next bucket, so clouds of
    one bucket share their shapes. Truncation keeps a uniform random
    subsample (deterministic seed) rather than a spatial prefix.
    """
    n = points.shape[0]
    if n > bucket:
        sel = np.random.default_rng(0).choice(n, size=bucket, replace=False)
        sel.sort()
        return points[sel].astype(np.float32), np.ones(bucket, np.float32)
    pad = bucket - n
    pts = np.concatenate([points, np.zeros((pad, 3), points.dtype)]).astype(np.float32)
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return pts, mask


def bucket_for(n: int, buckets=(1024, 2048, 4096, 8192, 16384, 32768, 65536)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
