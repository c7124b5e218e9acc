"""Named run configurations, one per benchmark configuration (port of
`saccot_tpu/cli/configs.py`; `tests/test_torch_isolation.py` holds the table
equal to the JAX package's field by field).

  1. bunny       synthetic Bunny-class two-view pairs through the whole
                 pipeline (ISS + SHOT, ~1k correspondences)
  2. u3m         object-scale all-pairs sweep over one model's views,
                 recall under the model-RMSE criterion
  3. threedmatch external correspondences in batches, 15 deg / 30 cm recall
  4. kitti       LiDAR-scale pairs, N = 50,000 correspondences
  5. slam        a scan sequence: pairwise edges, pose graph, track BA, ATE

The data are synthetic, sized and parameterised to the real datasets'
operating points; real data enter through `io/loaders` and the files,
sequence and external modes. `features/pipeline.py` (`BUNNY_PIPE`),
`slam/frontend.py` (`SLAM_PARAMS`) and `evaluation/ablation.py`
(`OBJ_PARAMS`) restate parts of this table for the modules below the
command line, which cannot import it (it imports `PipelineConfig`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from saccot_tpu_torch.features.pipeline import PipelineConfig
from saccot_tpu_torch.utils.params import SacCotParams

IMPLS = ("auto", "kernel", "plain")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    kind: str                     # pipeline | u3m | sweep | kitti | slam
    seed: int = 0
    # sweep/correspondence-level
    n_pairs: int = 16
    n_views: int = 10             # u3m all-pairs: views per model
    n_corr: int = 1000
    outlier_ratio: float = 0.8
    noise: float = 0.004
    params: SacCotParams = SacCotParams()
    # pipeline-level
    pipeline: Optional[PipelineConfig] = None
    n_points: int = 4096
    # slam-level
    n_scans: int = 8
    loop_every: int = 3
    # the estimator's route: "kernel" (the CUDA kernels on the card),
    # "plain" (the plain PyTorch versions), or "auto", which is "kernel"
    impl: str = "auto"
    # recall criterion
    rot_thresh_deg: float = 15.0
    trans_thresh: float = 0.30
    # U3M-style alternative criterion: RMSE of the source cloud between
    # T_est and T_gt below rmse_mult * mesh resolution (the object-scale
    # protocol). Used when use_model_rmse is set.
    use_model_rmse: bool = False
    rmse_mult: float = 5.0
    # Fraction of the surface the two synthetic views share (pipeline
    # configs; io/synthetic.two_view_pair); for u3m the eligibility
    # threshold of the headline recall.
    overlap: float = 0.8

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")


_OBJ_PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=256, neighbors_per_anchor=16, max_hypotheses=1024,
)

_PIPE = PipelineConfig(
    normal_k=16, iss_salient_mult=5.0, iss_nms_mult=3.0, max_keypoints=1024,
    descriptor="shot", descriptor_radius_mult=10.0, descriptor_k=48,
    max_correspondences=1024, compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
    estimator=SacCotParams(num_anchors=192, neighbors_per_anchor=12, max_hypotheses=512),
)

CONFIGS = {
    "bunny": RunConfig(
        name="bunny", kind="pipeline", seed=9, n_pairs=4, n_points=8192,
        pipeline=_PIPE, rot_thresh_deg=5.0, trans_thresh=0.05,
    ),
    "u3m": RunConfig(
        name="u3m", kind="u3m", seed=100, n_points=4096,
        pipeline=_PIPE, rot_thresh_deg=5.0, trans_thresh=0.05,
        use_model_rmse=True, rmse_mult=5.0,
        # V=10 views of one model, the complete V(V-1)/2 = 45-pair sweep,
        # recall over the pairs with exact per-pair overlap from the shared
        # model indices; `overlap` is the eligibility threshold of the
        # headline recall (pairs below it share too little surface to be
        # registrable in principle). The runner also reports all-pairs
        # recall and a recall-vs-overlap-band table.
        n_views=10, overlap=0.3,
    ),
    "threedmatch": RunConfig(
        name="threedmatch", kind="sweep", seed=300, n_pairs=32, n_corr=2048,
        outlier_ratio=0.9, noise=0.01,
        params=dataclasses.replace(_OBJ_PARAMS, compat_tau=0.05, inlier_tau=0.05,
                                   min_separation=0.1, max_hypotheses=2048),
        rot_thresh_deg=15.0, trans_thresh=0.30,
    ),
    "kitti": RunConfig(
        name="kitti", kind="kitti", seed=500, n_pairs=2, n_corr=50000,
        outlier_ratio=0.7, noise=0.05,
        params=SacCotParams(
            compat_tau=0.3, min_separation=1.0, inlier_tau=0.3,
            num_anchors=512, neighbors_per_anchor=16, max_hypotheses=2048,
            degree_block_rows=512,
        ),
        rot_thresh_deg=5.0, trans_thresh=0.6,
    ),
    "slam": RunConfig(
        name="slam", kind="slam", seed=700, n_scans=10, n_corr=512,
        outlier_ratio=0.5, noise=0.004, loop_every=3,
        params=SacCotParams(
            compat_tau=0.03, min_separation=0.08, inlier_tau=0.03,
            num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
        ),
    ),
}


def estimator_impl(impl: str) -> str:
    """The estimator route a run configuration's `impl` names."""
    return "kernel" if impl == "auto" else impl
