"""Real-3DMatch protocol: per-fragment `.npz` descriptors + gt.log (port of
`saccot_tpu/cli/external.py`).

    python -m saccot_tpu_torch.cli.main external --dir <fragments/> --gt-log <gt.log>

Inputs:
  - a directory of `<anything>_<index>.npz` archives (keys `xyz` [N, 3],
    `desc` [N, D], `io/external.py`'s format; the trailing integer of the
    stem is the fragment index gt.log refers to);
  - a 3DMatch-style `gt.log` (`io/loaders.load_gt_log`) in the
    Redwood/3DMatch convention: entry (i, j) holds T = inv(pose_i) @ pose_j,
    the transform taking fragment j's points into fragment i's frame. The
    estimator's T maps P (source) into Q's (target) frame, so each pair is
    registered with fragment j as the source and fragment i as the target.

Every fragment is padded to one keypoint bucket (the next power of two)
with a mask; each gt pair is matched in descriptor space (`match/topk`),
and the correspondence sets are registered in batches of `batch` pairs
with their masks. Recall is RE < 15 deg and TE < 30 cm over the listed pairs.
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from saccot_tpu_torch.cli.configs import estimator_impl
from saccot_tpu_torch.engine.sac_cot import register_batch
from saccot_tpu_torch.evaluation.metrics import registration_error
from saccot_tpu_torch.io.external import load_descriptors_npz
from saccot_tpu_torch.io.loaders import load_gt_log, save_log
from saccot_tpu_torch.match.topk import match_descriptors, mutual_filter
from saccot_tpu_torch.utils.params import SacCotParams


def discover_fragments(desc_dir: str) -> Dict[int, str]:
    """Map fragment index -> npz path, from trailing integers in filenames."""
    out: Dict[int, str] = {}
    for name in sorted(os.listdir(desc_dir)):
        if not name.endswith(".npz"):
            continue
        m = re.search(r"(\d+)\.npz$", name)
        if m is None:
            continue
        out[int(m.group(1))] = os.path.join(desc_dir, name)
    return out


def _pad_fragment(
    frag: Dict[str, np.ndarray], bucket: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (xyz, desc) to `bucket` rows with a validity mask."""
    n = frag["xyz"].shape[0]
    if n > bucket:
        raise ValueError(f"fragment has {n} keypoints > bucket {bucket}")
    pad = bucket - n
    xyz = np.concatenate([frag["xyz"], np.zeros((pad, 3), np.float32)])
    desc = np.concatenate(
        [frag["desc"], np.zeros((pad, frag["desc"].shape[1]), np.float32)]
    )
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return xyz, desc, mask


def match_pair(src, tgt, max_corr: int, mutual: bool, ratio_test: float):
    """One fragment pair, each (xyz, desc, mask) padded tensors -> the
    fixed-size (P, Q, mask) correspondence set."""
    xyz_s, desc_s, m_s = src
    xyz_t, desc_t, m_t = tgt
    m = match_descriptors(desc_s, desc_t, mask_src=m_s, mask_tgt=m_t,
                          mutual=mutual, ratio_test=ratio_test)
    m = mutual_filter(m, max_corr)
    return xyz_s[m.src_idx], xyz_t[m.tgt_idx], m.valid.to(torch.float32)


def run_external(
    desc_dir: str,
    gt_log_path: str,
    params: Optional[SacCotParams] = None,
    max_correspondences: int = 2048,
    mutual: bool = True,
    ratio_test: float = 0.0,
    rot_thresh_deg: float = 15.0,
    trans_thresh: float = 0.30,
    impl: str = "auto",
    batch: int = 8,
    log=None,
    out_log: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Run the external-descriptor registration protocol; return metrics.

    `compile_s` is the first matched and registered batch, outside the
    timed region: the kernel build and the first launches. `pairs_per_sec`
    covers matching and registration of every pair, ending in the host copy
    of the last batch's transforms.
    """
    if params is None:
        # Scene-scale (metric) thresholds: the threedmatch config's values.
        params = SacCotParams(
            compat_tau=0.05, min_separation=0.1, inlier_tau=0.05,
            num_anchors=256, neighbors_per_anchor=16, max_hypotheses=2048,
        )
    impl = estimator_impl(impl)

    frags = discover_fragments(desc_dir)
    if not frags:
        raise FileNotFoundError(f"no *_<index>.npz fragments under {desc_dir}")
    gt = load_gt_log(gt_log_path)
    pair_ids: List[Tuple[int, int]] = [
        (i, j) for (i, j) in sorted(gt) if i in frags and j in frags
    ]
    if not pair_ids:
        raise ValueError("gt.log lists no pairs with fragments present on disk")

    loaded = {k: load_descriptors_npz(frags[k]) for k in frags}
    bucket = 1
    for f in loaded.values():
        bucket = max(bucket, f["xyz"].shape[0])
    bucket = 1 << (bucket - 1).bit_length()  # next power of two
    padded = {k: tuple(torch.as_tensor(a, device=device) for a in _pad_fragment(f, bucket))
              for k, f in loaded.items()}

    n_pairs = len(pair_ids)
    max_c = min(max_correspondences, bucket)

    def register(sets):
        return register_batch(torch.stack([s[0] for s in sets]),
                              torch.stack([s[1] for s in sets]), params,
                              mask=torch.stack([s[2] for s in sets]), impl=impl)

    t_c0 = time.perf_counter()
    i0, j0 = pair_ids[0]
    first = match_pair(padded[j0], padded[i0], max_c, mutual, ratio_test)
    register([first] * batch).num_inliers.cpu()
    compile_s = time.perf_counter() - t_c0

    t0 = time.perf_counter()
    # Stage 1: match every gt pair. gt (i, j) maps fragment j into fragment
    # i's frame, so fragment j is the source, fragment i the target.
    sets = [match_pair(padded[j], padded[i], max_c, mutual, ratio_test)
            for (i, j) in pair_ids]

    # Stage 2: register in fixed-size batches (the tail padded with repeats,
    # which are not evaluated).
    n_batches = -(-n_pairs // batch)
    results_T = np.zeros((n_pairs, 4, 4), np.float64)
    results_inl = np.zeros((n_pairs,), np.int64)
    for bi in range(n_batches):
        sl = [min(bi * batch + k, n_pairs - 1) for k in range(batch)]
        res = register([sets[s] for s in sl])
        T_np = res.T.cpu().numpy().astype(np.float64)
        inl_np = res.num_inliers.cpu().numpy().astype(np.int64)
        for k in range(batch):
            s = bi * batch + k
            if s < n_pairs:
                results_T[s] = T_np[k]
                results_inl[s] = inl_np[k]
    dt_total = time.perf_counter() - t0

    # Evaluation: RE/TE recall over the gt.log pairs.
    flags = []
    for s, (i, j) in enumerate(pair_ids):
        re_deg, te = registration_error(results_T[s], gt[(i, j)])
        ok = (re_deg < rot_thresh_deg) and (te < trans_thresh)
        flags.append(ok)
        if log is not None:
            log.log(dict(
                pair=[i, j], rot_err_deg=re_deg, trans_err=te,
                registered=bool(ok), num_inliers=int(results_inl[s]),
            ))
    recall = float(np.mean(flags))

    if out_log:
        # The standard .log trajectory of the estimated transforms, which the
        # public 3DMatch/Redwood evaluation scripts read.
        save_log(
            out_log,
            {pair_ids[s]: results_T[s] for s in range(n_pairs)},
            n_fragments=len(frags),
        )

    return dict(
        config="external",
        n_fragments=len(frags),
        n_pairs=n_pairs,
        bucket=bucket,
        recall=recall,
        mean_inliers=float(results_inl.mean()),
        pairs_per_sec=n_pairs / dt_total,
        compile_s=compile_s,
        rot_thresh_deg=rot_thresh_deg,
        trans_thresh=trans_thresh,
        impl=impl,
    )
