"""Parameter surface of the SAC-COT estimator (the port's own copy).

The same frozen dataclass as `saccot_tpu/utils/params.py`, field for field
and default for default (`tests/test_torch_isolation.py` holds the two
equal): compatibility threshold `compat_tau`, inlier threshold `inlier_tau`,
the pair-separation guard, and the fixed-budget triangle pool
(`num_anchors` nodes of highest weighted degree, `neighbors_per_anchor`
strongest edges each, the best `max_hypotheses` triangles kept).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SacCotParams:
    """Static configuration for one SAC-COT registration problem size."""

    # --- geometric thresholds -------------------------------------------
    # Edge (i, j) exists iff | ||p_i-p_j|| - ||q_i-q_j|| | < compat_tau and
    # both intra-cloud distances exceed min_separation.
    compat_tau: float = 0.1
    min_separation: float = 0.05
    # Correspondence i is an inlier of hypothesis T iff ||T p_i - q_i|| < inlier_tau.
    inlier_tau: float = 0.1

    # --- triangle pool budget (static shapes) ---------------------------
    num_anchors: int = 256
    neighbors_per_anchor: int = 16
    max_hypotheses: int = 1024  # "K": ranked triangles tried

    # --- refinement -----------------------------------------------------
    # Fixed-count weighted-Umeyama re-fits on the best hypothesis' inliers.
    refine_iters: int = 2

    # --- scoring --------------------------------------------------------
    # "count": plain inlier counting; "weighted": inliers weighted by 1 - d/tau.
    scoring: str = "count"

    # --- blocking (perf tuning only, no semantic effect) ----------------
    degree_block_rows: int = 256   # row-block size of the virtual compat matrix
    score_block_k: int = 256       # hypothesis-axis block size in scoring

    # --- triangle-pool variants -----------------------------------------
    # True: drop cross-anchor duplicate triangles, exact global top-K.
    dedup_triangles: bool = True
    # True: the JAX package may take an approximate top-K (the port takes
    # the exact one).
    approx_topk: bool = False
    # Under correspondence-axis sharding, compute degrees with the column-
    # block ring (dist/ring.py) instead of the point all-gather + local
    # blocks. Same result up to f32 summation order.
    ring_compat: bool = False
    # >0: keep each anchor's top-T candidate triangles before the global
    # top-K. Requires dedup_triangles=False. 0 = exact global ranking.
    per_anchor_candidates: int = 0

    def __post_init__(self):
        if self.compat_tau <= 0:
            raise ValueError("compat_tau must be positive")
        if self.inlier_tau <= 0:
            raise ValueError("inlier_tau must be positive")
        if self.neighbors_per_anchor < 2:
            raise ValueError("neighbors_per_anchor must be >= 2 to form triangles")
        if self.scoring not in ("count", "weighted"):
            raise ValueError(f"unknown scoring mode: {self.scoring!r}")
        if self.per_anchor_candidates and self.dedup_triangles:
            raise ValueError(
                "per_anchor_candidates requires dedup_triangles=False "
                "(the pre-reduced pool has no canonical ordering to dedup)"
            )

    def with_scale(self, resolution: float) -> "SacCotParams":
        """Scale thresholds expressed in mesh-resolution units to metric units."""
        return dataclasses.replace(
            self,
            compat_tau=self.compat_tau * resolution,
            min_separation=self.min_separation * resolution,
            inlier_tau=self.inlier_tau * resolution,
        )


def num_candidate_triangles(p: SacCotParams) -> int:
    """Size of the static candidate-triple pool before ranking."""
    b = p.neighbors_per_anchor
    return p.num_anchors * (b * (b - 1) // 2)
