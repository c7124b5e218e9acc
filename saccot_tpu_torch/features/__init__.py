"""Point-cloud features (port of `saccot_tpu/features`): kNN, normals, mesh
resolution, voxel grid, ISS / Harris keypoints, SHOT / FPFH descriptors and
the cloud-to-transform pipeline (`features/pipeline.py`)."""
