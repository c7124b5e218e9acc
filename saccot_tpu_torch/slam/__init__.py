"""SE(3) algebra for ICP and, later, the SLAM layer (port of `saccot_tpu/slam`)."""
