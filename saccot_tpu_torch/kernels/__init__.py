"""Hand-written CUDA kernels of the estimator's main path, one module each.

Each module holds the kernel's wrapper and, beside it, the plain PyTorch
version of the same function (`*_reference`). A wrapper launches its kernel
for CUDA tensors and takes the plain version only for CPU tensors.

- `compat.degrees`              <- csrc/compat_degrees.cu (TPU: _degree_kernel_mxu)
- `triangles.anchor_neighbors`  <- csrc/anchor_topb.cu    (TPU: _anchor_topb_kernel)
- `solve3.solve3`               <- csrc/solve3.cu         (TPU: _solve_kernel + XLA Horn)
- `score.score_hypotheses`      <- csrc/score.cu          (TPU: _score_kernel)
- `refine.refine`               <- csrc/refine.cu         (TPU: none, the refine ran in XLA)

`_build` compiles `csrc/*.cu` on first use and keeps the launch counters.
"""
