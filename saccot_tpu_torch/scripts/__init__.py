"""Experiment scripts of the port, each run as `python -m saccot_tpu_torch.scripts.<name>`."""
