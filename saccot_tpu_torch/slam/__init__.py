"""SE(3) algebra, pose-graph optimization, bundle adjustment and sequence
SLAM (port of `saccot_tpu/slam`)."""
from saccot_tpu_torch.slam.ba import BAProblem, BAResult, bundle_adjust  # noqa: F401
from saccot_tpu_torch.slam.frontend import SequenceResult, run_sequence  # noqa: F401
from saccot_tpu_torch.slam.posegraph import PGOResult, PoseGraph, optimize_pose_graph  # noqa: F401
