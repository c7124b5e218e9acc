"""The registration pipeline: two raw clouds in, a rigid transform out.

Port of `saccot_tpu/features/pipeline.py`: mesh resolution -> optional
voxel grid -> one shared self-kNN -> normals -> ISS or Harris keypoints ->
SHOT or FPFH descriptors -> GEMM + top-k matching -> the SAC-COT estimator
-> optional ICP polish. Thresholds are multiples of the source cloud's mesh
resolution `pr`; the geometry is rescaled to pr units before the estimator
(so its thresholds stay config constants) and the translation is scaled
back. ICP runs in pr units too.

`register_clouds_batch` runs the feature stages cloud by cloud (a Python
loop over the pairs) and the estimator once for the whole batch: the
correspondence sets [batch, max_correspondences, 3] and their masks go
through one `register_batch` call, on its kernels (`impl="kernel"`) or its
plain versions (`impl="plain"`). Every count stays a tensor, so no stage
waits on the host. Each stage runs inside a `torch.profiler` range named
`STAGE_PREFIX + <stage>` (resolution, voxel, knn_normals, keypoints,
descriptors, matching, estimator, icp), so a profile of any call reads
each stage's host and device time (`utils.profile.profile_call`).

The bunny run configuration (`saccot_tpu/cli/configs.py`, `_PIPE` and
"bunny") is restated at the end (`BUNNY_PIPE`, `bunny_pairs`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from saccot_tpu_torch.engine.icp import IcpParams, icp_batch
from saccot_tpu_torch.engine.sac_cot import RegistrationResult, register_batch
from saccot_tpu_torch.features.fpfh import fpfh_descriptors
from saccot_tpu_torch.features.harris import harris_keypoints
from saccot_tpu_torch.features.iss import Keypoints, iss_keypoints
from saccot_tpu_torch.features.neighbors import knn
from saccot_tpu_torch.features.normals import estimate_normals
from saccot_tpu_torch.features.resolution import mesh_resolution
from saccot_tpu_torch.features.shot import shot_descriptors
from saccot_tpu_torch.features.voxel import voxel_downsample
from saccot_tpu_torch.io.synthetic import two_view_pair
from saccot_tpu_torch.match.topk import match_descriptors, mutual_filter
from saccot_tpu_torch.utils.params import SacCotParams


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the cloud -> transform pipeline.

    All radii and thresholds are multiples of the source cloud's mesh
    resolution `pr`, or of `metric_scale` where it is set (scene-scale
    data). The JAX package's fields and defaults, except `impl`.
    `approx_knn` is accepted only so the fields stay the JAX package's: the
    port always selects neighbours exactly and reads no value there.
    """

    # preprocessing
    voxel_mult: float = 0.0          # voxel size in pr units; 0 disables
    max_cloud_points: int = 8192     # static budget after downsampling
    normal_k: int = 16
    approx_knn: bool = True          # read by nothing (see above)

    # keypoints
    keypoints: str = "iss"           # "iss" | "harris"
    iss_salient_mult: float = 4.0
    iss_nms_mult: float = 3.0
    iss_gamma21: float = 0.975
    iss_gamma32: float = 0.975
    harris_k: float = 0.04
    max_keypoints: int = 1024

    # descriptors
    descriptor: str = "shot"         # "shot" | "fpfh"
    descriptor_radius_mult: float = 8.0
    descriptor_k: int = 64
    descriptor_soft: bool = True     # soft (interpolated) histogram binning

    # matching
    max_correspondences: int = 1024
    mutual: bool = True
    ratio_test: float = 0.0

    # estimator thresholds in pr units
    compat_mult: float = 5.0
    min_sep_mult: float = 8.0
    inlier_mult: float = 5.0
    estimator: SacCotParams = SacCotParams()
    # the estimator's route: "kernel" (the CUDA kernels on the card) or
    # "plain" (the plain PyTorch versions), as `register_batch` takes it
    impl: str = "kernel"

    # optional dense-cloud ICP polish (distances in pr units); None disables
    icp: Optional[IcpParams] = None

    metric_scale: Optional[float] = None

    def __post_init__(self):
        if self.descriptor not in ("shot", "fpfh"):
            raise ValueError(f"unknown descriptor {self.descriptor!r}")
        if self.keypoints not in ("iss", "harris"):
            raise ValueError(f"unknown keypoint detector {self.keypoints!r}")
        if self.impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {self.impl!r}")


class PipelineResult(NamedTuple):
    registration: RegistrationResult
    resolution: torch.Tensor
    num_keypoints_src: torch.Tensor   # int32
    num_keypoints_tgt: torch.Tensor   # int32
    num_correspondences: torch.Tensor  # int32
    # Weighted inlier RMSE of the ICP polish in pr units; 0 without ICP.
    icp_rmse: torch.Tensor
    # The matched correspondence sets in metric units ([max_correspondences,
    # 3] each) and their mask (float32 [max_correspondences], the valid rows
    # first), as the estimator took them: what the SLAM layer derives edge
    # information from. (The JAX package fills corr_P / corr_Q in
    # `register_scan_features` only.)
    corr_P: torch.Tensor
    corr_Q: torch.Tensor
    corr_mask: torch.Tensor


class ScanFeatures(NamedTuple):
    """Per-scan features, reusable across every pair the scan appears in."""

    kp_xyz: torch.Tensor      # [max_keypoints, 3]
    kp_valid: torch.Tensor    # [max_keypoints] bool
    desc: torch.Tensor        # [max_keypoints, D]
    resolution: torch.Tensor  # 0-d: the pr used for this scan's radii


# -- stages -------------------------------------------------------------------

# The profiler ranges of the stages are named STAGE_PREFIX + <stage>.
STAGE_PREFIX = "pipeline/"


def _stage(name: str):
    return record_function(STAGE_PREFIX + name)


def cloud_resolution(points: torch.Tensor, cfg: PipelineConfig,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`metric_scale`, or the mesh resolution of the cloud (0-d)."""
    if cfg.metric_scale is not None:
        return torch.tensor(cfg.metric_scale, dtype=torch.float32, device=points.device)
    with _stage("resolution"):
        return mesh_resolution(points, mask=mask)


def _downsample(points, cfg: PipelineConfig, pr, mask):
    with _stage("voxel"):
        return voxel_downsample(points, cfg.voxel_mult * pr, cfg.max_cloud_points, mask)


def neighbors_and_normals(points: torch.Tensor, cfg: PipelineConfig,
                          mask: Optional[torch.Tensor] = None):
    """One shared self-kNN (k = max(normal_k, 32), self included) for the
    normals and the ISS saliency and NMS, and the normals. -> (nbrs, normals)."""
    nbrs = knn(points, points, k=max(cfg.normal_k, 32), query_mask=mask, ref_mask=mask)
    return nbrs, estimate_normals(points, k=cfg.normal_k, mask=mask, neighbors=nbrs)


def detect_keypoints(points, normals, nbrs, cfg: PipelineConfig, pr,
                     mask: Optional[torch.Tensor] = None) -> Keypoints:
    if cfg.keypoints == "harris":
        return harris_keypoints(points, normals, radius=cfg.iss_salient_mult * pr,
                                nms_radius=cfg.iss_nms_mult * pr,
                                max_keypoints=cfg.max_keypoints, harris_k=cfg.harris_k,
                                mask=mask)
    return iss_keypoints(points, salient_radius=cfg.iss_salient_mult * pr,
                         nms_radius=cfg.iss_nms_mult * pr, max_keypoints=cfg.max_keypoints,
                         gamma21=cfg.iss_gamma21, gamma32=cfg.iss_gamma32, mask=mask,
                         neighbors=nbrs)


def describe_keypoints(points, normals, kps: Keypoints, cfg: PipelineConfig, pr,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    fn = shot_descriptors if cfg.descriptor == "shot" else fpfh_descriptors
    return fn(points, normals, kps.idx, cfg.descriptor_radius_mult * pr, k=cfg.descriptor_k,
              mask=mask, soft=cfg.descriptor_soft)


def extract_features(points: torch.Tensor, cfg: PipelineConfig, pr,
                     mask: Optional[torch.Tensor] = None) -> Tuple[Keypoints, torch.Tensor]:
    """Keypoints + descriptors of one cloud; pr: its mesh resolution."""
    with _stage("knn_normals"):
        nbrs, normals = neighbors_and_normals(points, cfg, mask)
    with _stage("keypoints"):
        kps = detect_keypoints(points, normals, nbrs, cfg, pr, mask)
    with _stage("descriptors"):
        return kps, describe_keypoints(points, normals, kps, cfg, pr, mask)


def correspondences(kp_src: torch.Tensor, valid_src: torch.Tensor, desc_src: torch.Tensor,
                    kp_tgt: torch.Tensor, valid_tgt: torch.Tensor, desc_tgt: torch.Tensor,
                    cfg: PipelineConfig):
    """Descriptor matching, then the best `max_correspondences`:
    (P [M, 3], Q [M, 3], mask [M] float32, the valid rows first)."""
    with _stage("matching"):
        m = mutual_filter(match_descriptors(desc_src, desc_tgt, mask_src=valid_src,
                                            mask_tgt=valid_tgt, mutual=cfg.mutual,
                                            ratio_test=cfg.ratio_test),
                          cfg.max_correspondences)
        return kp_src[m.src_idx], kp_tgt[m.tgt_idx], m.valid.to(torch.float32)


def estimator_params(cfg: PipelineConfig) -> SacCotParams:
    """The estimator's parameters with the thresholds in pr units."""
    return dataclasses.replace(cfg.estimator, compat_tau=float(cfg.compat_mult),
                               min_separation=float(cfg.min_sep_mult),
                               inlier_tau=float(cfg.inlier_mult))


def pr_units(x: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Points [batch, n, 3] in units of their pair's resolution pr [batch]."""
    return x * (1.0 / torch.clamp_min(pr, 1e-12))[:, None, None]


def estimate(P: torch.Tensor, Q: torch.Tensor, cmask: torch.Tensor, pr: torch.Tensor,
             cfg: PipelineConfig) -> RegistrationResult:
    """One `register_batch` call on the batch's correspondence sets
    ([batch, M, 3], mask [batch, M]), rescaled to pr units ([batch]); the
    result is in pr units."""
    with _stage("estimator"):
        return register_batch(pr_units(P, pr), pr_units(Q, pr), estimator_params(cfg),
                              mask=cmask, impl=cfg.impl)


def _metric(reg: RegistrationResult, pr: torch.Tensor) -> RegistrationResult:
    """Scale the translation back to metric units (R is scale-free)."""
    t = reg.t * pr[:, None]
    T = reg.T.clone()
    T[:, :3, 3] = t
    return reg._replace(t=t, T=T)


def _unbatch(res: PipelineResult) -> PipelineResult:
    """Drop the leading batch axis of a batch of one."""
    return PipelineResult(*(RegistrationResult(*(y[0] for y in x))
                            if isinstance(x, RegistrationResult) else x[0] for x in res))


# -- entry points ---------------------------------------------------------------

def _as_points(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _as_mask(x, device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=device)


def register_clouds_batch(
    src,
    tgt,
    cfg: PipelineConfig,
    src_mask=None,
    tgt_mask=None,
    device="cuda",
) -> PipelineResult:
    """End to end over a batch of cloud pairs: src, tgt [batch, N, 3]
    (arrays or tensors, put on `device`); masks optional [batch, N]. Every
    field of the result has the batch axis. target = T * source."""
    src, tgt = _as_points(src, device), _as_points(tgt, device)
    src_mask, tgt_mask = _as_mask(src_mask, device), _as_mask(tgt_mask, device)
    batch = src.shape[0]
    clouds, prs, Ps, Qs, cms, counts = ([], [], [], []), [], [], [], [], []
    for b in range(batch):
        s, t = src[b], tgt[b]
        sm = None if src_mask is None else src_mask[b]
        tm = None if tgt_mask is None else tgt_mask[b]
        pr = cloud_resolution(s, cfg, sm)
        if cfg.voxel_mult > 0:
            # Radii keep the resolution of the original cloud.
            s, sm = _downsample(s, cfg, pr, sm)
            t, tm = _downsample(t, cfg, pr, tm)
        kp_s, d_s = extract_features(s, cfg, pr, mask=sm)
        kp_t, d_t = extract_features(t, cfg, pr, mask=tm)
        P, Q, cm = correspondences(kp_s.xyz, kp_s.valid, d_s, kp_t.xyz, kp_t.valid, d_t, cfg)
        for kept, x in zip(clouds, (s, t, sm, tm)):
            kept.append(x)
        prs.append(pr)
        Ps.append(P)
        Qs.append(Q)
        cms.append(cm)
        counts.append(torch.stack([kp_s.valid.sum(), kp_t.valid.sum(), (cm > 0).sum()]))
    pr = torch.stack(prs)
    reg = estimate(torch.stack(Ps), torch.stack(Qs), torch.stack(cms), pr, cfg)

    icp_rmse = torch.zeros(batch, dtype=torch.float32, device=src.device)
    if cfg.icp is not None:
        # The dense polish on the (downsampled) clouds in pr units, seeded
        # by the coarse estimate (still in pr units here).
        s, t, sm, tm = (None if xs[0] is None else torch.stack(xs) for xs in clouds)
        with _stage("icp"):
            pol = icp_batch(pr_units(s, pr), pr_units(t, pr), cfg.icp, T_init=reg.T,
                            mask_src=sm, mask_tgt=tm)
        reg = reg._replace(R=pol.R, t=pol.t, T=pol.T)
        icp_rmse = pol.rmse
    counts = torch.stack(counts).to(torch.int32)
    return PipelineResult(
        registration=_metric(reg, pr), resolution=pr, num_keypoints_src=counts[:, 0],
        num_keypoints_tgt=counts[:, 1], num_correspondences=counts[:, 2], icp_rmse=icp_rmse,
        corr_P=torch.stack(Ps), corr_Q=torch.stack(Qs), corr_mask=torch.stack(cms))


def register_clouds(
    src,
    tgt,
    cfg: PipelineConfig,
    src_mask=None,
    tgt_mask=None,
    device="cuda",
) -> PipelineResult:
    """End to end: two raw clouds [N, 3] -> rigid transform (target =
    T * source); a batch of one, returned without the batch axis."""
    add = lambda x: None if x is None else _as_mask(x, device)[None]
    return _unbatch(register_clouds_batch(_as_points(src, device)[None],
                                          _as_points(tgt, device)[None], cfg,
                                          add(src_mask), add(tgt_mask), device=device))


def extract_scan_features(points, cfg: PipelineConfig, mask=None, device="cuda") -> ScanFeatures:
    """One scan -> keypoints + descriptors, computed once for every pair
    the scan takes part in (pair them with `register_scan_features`)."""
    points, mask = _as_points(points, device), _as_mask(mask, device)
    pr = cloud_resolution(points, cfg, mask)
    if cfg.voxel_mult > 0:
        points, mask = _downsample(points, cfg, pr, mask)
    kps, desc = extract_features(points, cfg, pr, mask=mask)
    return ScanFeatures(kp_xyz=kps.xyz, kp_valid=kps.valid, desc=desc, resolution=pr)


def register_scan_features(src: ScanFeatures, tgt: ScanFeatures,
                           cfg: PipelineConfig) -> PipelineResult:
    """Match + estimate between two scans' precomputed features, with the
    source scan's resolution; `corr_P` / `corr_Q` are the matched sets in
    metric units."""
    P, Q, cm = correspondences(src.kp_xyz, src.kp_valid, src.desc, tgt.kp_xyz, tgt.kp_valid,
                               tgt.desc, cfg)
    pr = src.resolution[None]
    reg = _metric(estimate(P[None], Q[None], cm[None], pr, cfg), pr)
    return _unbatch(PipelineResult(
        registration=reg, resolution=pr,
        num_keypoints_src=src.kp_valid.sum(dtype=torch.int32)[None],
        num_keypoints_tgt=tgt.kp_valid.sum(dtype=torch.int32)[None],
        num_correspondences=(cm > 0).sum(dtype=torch.int32)[None],
        icp_rmse=torch.zeros(1, dtype=torch.float32, device=P.device),
        corr_P=P[None], corr_Q=Q[None], corr_mask=cm[None]))


# -- the bunny run configuration ------------------------------------------------

# `saccot_tpu/cli/configs.py`'s `_PIPE` and "bunny", restated: the full
# pipeline, ISS + SHOT (soft bins) on 4 synthetic two-view pairs of 8,192
# points a view, as `run_pipeline_config` (`saccot_tpu/cli/runners.py`)
# makes them.
BUNNY_PIPE = PipelineConfig(
    normal_k=16, iss_salient_mult=5.0, iss_nms_mult=3.0, max_keypoints=1024,
    descriptor="shot", descriptor_radius_mult=10.0, descriptor_k=48,
    max_correspondences=1024, compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
    estimator=SacCotParams(num_anchors=192, neighbors_per_anchor=12, max_hypotheses=512),
)
BUNNY_SEED = 9
BUNNY_PAIRS = 4
BUNNY_N_POINTS = 8192
BUNNY_OVERLAP = 0.8
BUNNY_NOISE = 0.002
BUNNY_CRITERION = (5.0, 0.05)  # rotation degrees, translation (model units)


def bunny_pairs(seeds: Iterable[int], device="cuda", n_points: int = BUNNY_N_POINTS):
    """The bunny configuration's view pairs `two_view_pair(seed=s,
    n_points, overlap=0.8, noise=0.002)` stacked: (source, target)
    [batch, n_points, 3] on `device` and T_gt [batch, 4, 4] NumPy float64.
    Each view holds exactly n_points (it is cut from 2 n_points samples)."""
    pairs = [two_view_pair(seed=s, n_points=n_points, overlap=BUNNY_OVERLAP, noise=BUNNY_NOISE)
             for s in seeds]
    return (_as_points(np.stack([p["source"] for p in pairs]), device),
            _as_points(np.stack([p["target"] for p in pairs]), device),
            np.stack([p["T_gt"] for p in pairs]))
