"""PyTorch port vs the JAX package: compatibility degrees and the dense matrix.

The JAX side runs as tests/test_kernels.py runs it (Pallas in interpret mode
on the CPU); both sides get the same NumPy inputs. Kernel-vs-plain checks
need a card and skip here.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from saccot_tpu.io.synthetic import correspondence_problem
from saccot_tpu.kernels.compat import degrees_pallas
from saccot_tpu.oracle import saccot as oracle
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu_torch.engine import compat as tcompat
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
)
JAX_PARAMS = JaxSacCotParams(**dataclasses.asdict(PARAMS))


@pytest.fixture(scope="module")
def probs():
    return [correspondence_problem(seed=31 + s, n=300, outlier_ratio=0.5) for s in range(2)]


def _stack(probs, key):
    return np.stack([p[key] for p in probs])


@pytest.mark.parametrize("masked", [False, True])
def test_degrees_match_pallas(probs, masked):
    """Masks and a nonzero row offset: rows 100:300 of the full result."""
    P, Q = _stack(probs, "P"), _stack(probs, "Q")
    mask = np.ones((2, 300), np.float32)
    if masked:
        mask[0, 200:] = 0
        mask[1, ::7] = 0
    off = 100 if masked else 0
    ref = np.stack([
        np.asarray(degrees_pallas(
            jnp.asarray(P[b, off:]), jnp.asarray(Q[b, off:]), jnp.asarray(P[b]),
            jnp.asarray(Q[b]), JAX_PARAMS, row_offset=off,
            mask_rows=jnp.asarray(mask[b, off:]) if masked else None,
            mask_cols=jnp.asarray(mask[b]) if masked else None))
        for b in range(2)
    ])
    tP, tQ, tm = torch.from_numpy(P), torch.from_numpy(Q), torch.from_numpy(mask)
    got = kcompat.degrees(
        tP[:, off:], tQ[:, off:], tP, tQ, PARAMS, row_offset=off,
        mask_rows=tm[:, off:] if masked else None, mask_cols=tm if masked else None)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_degrees_blocking_is_invisible(probs):
    """Row blocks of any size give the same degrees as one block."""
    P = torch.from_numpy(_stack(probs, "P"))
    Q = torch.from_numpy(_stack(probs, "Q"))
    one = tcompat.degrees(P, Q, P, Q, PARAMS, block_rows=300)
    for rb in (1, 37, 128):
        np.testing.assert_allclose(
            tcompat.degrees(P, Q, P, Q, PARAMS, block_rows=rb).numpy(), one.numpy(),
            rtol=1e-6, atol=1e-6)


def test_compat_matrix_matches_oracle():
    prob = correspondence_problem(seed=11, n=96, outlier_ratio=0.5, noise=0.004)
    S_np = oracle.compat_scores(prob["P"], prob["Q"], JAX_PARAMS)
    S_t = tcompat.compat_matrix(torch.from_numpy(prob["P"])[None],
                                torch.from_numpy(prob["Q"])[None], PARAMS)
    np.testing.assert_allclose(S_t[0].numpy(), S_np, atol=2e-4)
    # Degrees are the row sums of the dense matrix.
    deg = kcompat.degrees(torch.from_numpy(prob["P"])[None], torch.from_numpy(prob["Q"])[None],
                          torch.from_numpy(prob["P"])[None], torch.from_numpy(prob["Q"])[None],
                          PARAMS)
    np.testing.assert_allclose(deg[0].numpy(), S_t[0].sum(-1).numpy(), rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    """The port and its engine import neither JAX, the JAX package nor any GPU
    toolchain."""
    code = (
        "import sys\n"
        "import saccot_tpu_torch, saccot_tpu_torch.engine, saccot_tpu_torch.kernels._build\n"
        "import saccot_tpu_torch.kernels.compat, saccot_tpu_torch.kernels.triangles\n"
        "import saccot_tpu_torch.kernels.solve3, saccot_tpu_torch.kernels.score\n"
        "import saccot_tpu_torch.utils.convert, saccot_tpu_torch.utils.profile\n"
        "import saccot_tpu_torch.kernels.ring_compat, saccot_tpu_torch.dist.ring\n"
        "import saccot_tpu_torch.dist.mesh, saccot_tpu_torch.dist.sweep, saccot_tpu_torch.dist.local\n"
        "import saccot_tpu_torch.kernels.compat_ops, saccot_tpu_torch.scripts.exp_compat_ops\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'saccot_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@needs_cuda
def test_degrees_kernel_matches_plain_on_card(probs):
    P = torch.from_numpy(_stack(probs, "P")).cuda()
    Q = torch.from_numpy(_stack(probs, "Q")).cuda()
    mask = torch.ones((2, 300), device="cuda")
    mask[:, ::5] = 0
    got = kcompat.degrees(P[:, 50:], Q[:, 50:], P, Q, PARAMS, row_offset=50,
                          mask_rows=mask[:, 50:], mask_cols=mask)
    ref = kcompat.degrees_reference(P[:, 50:], Q[:, 50:], P, Q, PARAMS, row_offset=50,
                                    mask_rows=mask[:, 50:], mask_cols=mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
