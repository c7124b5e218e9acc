"""The NumPy oracle: the port's CPU baseline and independent check."""

from saccot_tpu_torch.oracle.saccot import (  # noqa: F401
    compat_scores,
    enumerate_triangles,
    umeyama,
    count_inliers,
    sac_cot,
)
