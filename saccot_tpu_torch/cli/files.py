"""Register two point-cloud files (port of `saccot_tpu/cli/files.py`).

Load any supported format (PLY, PCD, KITTI .bin, .npy, .xyz/.txt), pad both
clouds to one bucket with validity masks, run the whole pipeline, and
report the estimated transform (and its errors when a ground truth is
given).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from saccot_tpu_torch.evaluation.metrics import registration_error
from saccot_tpu_torch.features.pipeline import PipelineConfig, register_clouds
from saccot_tpu_torch.io.loaders import bucket_for, load_cloud, pad_cloud
from saccot_tpu_torch.utils.params import SacCotParams


def register_files(
    src_path: str,
    tgt_path: str,
    descriptor: str = "shot",
    gt_path: Optional[str] = None,
    cfg: Optional[PipelineConfig] = None,
    device="cuda",
) -> Dict:
    """Load, bucket, register; returns a JSON-ready metrics dict."""
    src = load_cloud(src_path)
    tgt = load_cloud(tgt_path)
    bucket = max(bucket_for(len(src)), bucket_for(len(tgt)))
    src_p, src_m = pad_cloud(src, bucket)
    tgt_p, tgt_m = pad_cloud(tgt, bucket)
    if cfg is None:
        cfg = PipelineConfig(
            descriptor=descriptor,
            iss_salient_mult=5.0, iss_nms_mult=3.0,
            descriptor_radius_mult=10.0, descriptor_k=48,
            max_keypoints=min(1024, bucket // 4),
            max_correspondences=min(1024, bucket // 4),
            compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
            estimator=SacCotParams(
                num_anchors=192, neighbors_per_anchor=12, max_hypotheses=1024,
            ),
        )

    t0 = time.perf_counter()
    res = register_clouds(src_p, tgt_p, cfg, src_mask=src_m, tgt_mask=tgt_m, device=device)
    T = res.registration.T.cpu().numpy().astype(np.float64)  # the copy waits for the card
    dt = time.perf_counter() - t0

    out = dict(
        src=src_path,
        tgt=tgt_path,
        points=(int(len(src)), int(len(tgt))),
        bucket=bucket,
        success=bool(res.registration.success),
        num_keypoints=(int(res.num_keypoints_src), int(res.num_keypoints_tgt)),
        num_correspondences=int(res.num_correspondences),
        num_inliers=int(res.registration.num_inliers),
        resolution=float(res.resolution),
        T=T.tolist(),
        wall_s=dt,
    )
    if gt_path:
        T_gt = np.loadtxt(gt_path).reshape(4, 4)
        r, t = registration_error(T, T_gt)
        out["rot_err_deg"] = r
        out["trans_err"] = t
    return out
