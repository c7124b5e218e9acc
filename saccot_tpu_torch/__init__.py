"""saccot_tpu_torch — the SAC-COT estimator on PyTorch and CUDA.

A port of `saccot_tpu` (JAX with Pallas kernels for the TPU) to PyTorch for
an NVIDIA H100. Plain tensor code is PyTorch; each Pallas kernel on the
estimator's main path is a CUDA C++ kernel written for Hopper (`csrc/`),
built at first use and bound through `ctypes` (`kernels/_build.py`). On CPU
tensors every kernel wrapper runs its plain PyTorch version instead, which
is what the CPU tests hold against the JAX package.

Subpackages
-----------
- ``engine``   the estimator: compat degrees, triangle pool, Horn solve,
               scoring, `register_batch` / `register_pair`
- ``kernels``  CUDA kernel wrappers, their plain versions, the build
- ``utils``    numpy <-> torch conversion of inputs and results

The static configuration `SacCotParams` and the NumPy modules (synthetic
problems, oracle, SE(3) helpers, metrics) are shared with `saccot_tpu`,
which they import without importing JAX.
"""

__version__ = "0.1.0"

from saccot_tpu.utils.params import SacCotParams  # noqa: F401
from saccot_tpu_torch.engine.sac_cot import (  # noqa: F401
    RegistrationResult, register_batch, register_pair,
)
