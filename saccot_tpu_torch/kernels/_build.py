"""Build, load and count the hand-written CUDA kernels.

Every `.cu` file under `saccot_tpu_torch/csrc/` is compiled by its own
`nvcc -c`, all started together, and the objects are linked by one
`nvcc -shared` into a shared library with a plain C interface, loaded with
`ctypes`. The build happens at first use (never at import), into
`build/saccot_tpu_torch/` at the repository root, under a name that carries
a hash of the sources, so an edited source triggers a rebuild and an
unchanged one is reused.

Every entry point returns `cudaGetLastError()` right after its launch;
`check` raises on a non-zero code. `LAUNCHES` holds sixteen plain integers,
one per kernel (three for the fused anchor kernel: its neighbour, candidate
and top-T modes; two for the two-sided degree kernel: its own route and the
direct-form one; two for the timing variants of `compat_ops.cu`: one per
form; two for the refine: its passes and the separate fit of the sharded
refine), which a wrapper bumps exactly where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "saccot_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {
    "compat_degrees": 0,
    "compat_degrees_direct": 0,   # the same kernel on the direct-form route (mxu=False)
    "compat_degrees_tri": 0,      # symmetric route, N > 2048
    "anchor_topb": 0,             # neighbours only
    "anchor_topb_candidates": 0,  # + all B(B-1)/2 candidate scores
    "anchor_topb_topt": 0,        # + per-anchor top-T candidates
    "anchor_topb_stream": 0,      # neighbours over column chunks, N > 4096
    "candidate_topt": 0,          # top-T candidates from the neighbours' node ids
    "solve3": 0,
    "score": 0,
    "ring_degrees": 0,            # one ring step of the correspondence-sharded degrees
    "compat_ops_two_sided": 0,    # timing variants of the degree loop (compat_ops.cu)
    "compat_ops_tri": 0,
    "refine": 0,                  # a pass of the refine (csrc/refine.cu)
    "refine_fit": 0,              # the sharded refine's fit, after its all-reduce
    "pool_rank": 0,               # the exact pool's dedup and top-K (csrc/pool_rank.cu)
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "saccot_compat_degrees": [_P] * 7 + [_I, _I, _I, _L, _F, _F, _F, _I, _I, _P, _P, _P],
    "saccot_compat_degrees_tri": [_P] * 6 + [_I] * 3 + [_F, _F, _F, _P],
    "saccot_anchor_topb": [_P] * 10 + [_I] * 8 + [_F, _F, _F, _P],
    "saccot_anchor_topb_stream": [_P] * 11 + [_I] * 6 + [_F, _F, _F, _P],
    "saccot_candidate_topt": [_P] * 7 + [_I] * 6 + [_F, _F, _F, _P],
    "saccot_solve3": [_P] * 5 + [_I] * 4 + [_P],
    "saccot_score": [_P] * 10 + [_I] * 5 + [_F, _F, _I, _P],
    "saccot_ring_degrees": [_P] * 3 + [_I] * 3 + [_L, _L, _F, _F, _F, _I, _I, _P, _P, _P],
    "saccot_compat_ops": [_P] * 4 + [_I] * 5 + [_F] * 5 + [_I, _I, _P, _P],
    "saccot_refine_pass": [_I, _I] + [_P] * 12 + [_I, _I, _I, _F, _P],
    "saccot_refine_fit": [_P] * 6 + [_I, _P],
    "saccot_pool_rank": [_P] * 8 + [_I] * 7 + [_L, _P],
    "saccot_empty": [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found in $CUDA_HOME/bin, PATH or /usr/local/cuda/bin")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet: one
    `nvcc -c` per source, all at once, then one link."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libsaccot_kernels_{source_hash()}.so"
    log = out.with_suffix(".log")
    if out.exists():
        # Built by an earlier process: its compiler output is kept beside it.
        build_seconds = 0.0
        build_log = log.read_text() if log.exists() else ""
        return out
    nvcc = find_nvcc()
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [work / f"{src.stem}.o" for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [(src, proc, *proc.communicate()) for src, proc in zip(srcs, procs)]
    build_log = "".join(f"== {src.name}\n{o}{e}" for src, _, o, e in logs)
    failed = [f"{src.name} ({proc.returncode}):\n{e}" for src, proc, _, e in logs
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    tmp = work / out.name
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
    log.write_text(build_log)
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)
