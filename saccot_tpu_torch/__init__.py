"""saccot_tpu_torch — SAC-COT registration on PyTorch and CUDA.

A port of `saccot_tpu` (JAX with Pallas kernels for the TPU) to PyTorch for
an NVIDIA H100. Plain tensor code is PyTorch; each Pallas kernel on the
estimator's main path is a CUDA C++ kernel written for Hopper (`csrc/`),
built at first use and bound through `ctypes` (`kernels/_build.py`). On CPU
tensors every kernel wrapper runs its plain PyTorch version instead, which
is what the CPU tests hold against the JAX package.

Subpackages
-----------
- ``engine``   the estimator: compat degrees, triangle pool, Horn solve,
               scoring, `register_batch` / `register_pair`; ICP (`icp`);
               the RANSAC and edge-guided baselines (`baselines`)
- ``features`` kNN, normals, mesh resolution, voxel grid, ISS / Harris
               keypoints, SHOT / FPFH descriptors, and the cloud-to-transform
               pipeline `register_clouds` / `register_clouds_batch`
- ``match``    descriptor matching (Gram product + top-k, mutual filter)
- ``slam``     SE(3) algebra, pose-graph optimization (dense and PCG,
               edge-sharded), Schur-complement bundle adjustment
               (landmark-sharded), sequence SLAM `run_sequence`, the
               sharded dry runs
- ``kernels``  CUDA kernel wrappers, their plain versions, the build
- ``dist``     DP / TP / SP over `torch.distributed` process groups, the
               column-block ring, the sharded sweep, a local rank launcher
- ``utils``    `SacCotParams`, numpy <-> torch conversion, SE(3) helpers,
               the SLAM-state checkpoint
- ``io``, ``evaluation``  synthetic problems, `.npz` descriptors,
               registration criteria, trajectory errors and the sampler
               ablation `run_sampler_ablation`

The port imports nothing of `saccot_tpu`: the static configurations
(`SacCotParams`, `PipelineConfig`, `IcpParams`) and the NumPy helpers it
needs are its own copies, held equal to the JAX package's by
`tests/test_torch_isolation.py`.
"""

__version__ = "0.1.0"

from saccot_tpu_torch.engine.sac_cot import (  # noqa: F401
    RegistrationResult, register_batch, register_batch_sp, register_batch_tp, register_pair,
)
from saccot_tpu_torch.features.pipeline import (  # noqa: F401
    PipelineConfig, register_clouds, register_clouds_batch,
)
from saccot_tpu_torch.slam.frontend import run_sequence  # noqa: F401
from saccot_tpu_torch.utils.params import SacCotParams  # noqa: F401
