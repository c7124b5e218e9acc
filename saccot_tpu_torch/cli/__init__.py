"""The command line (`python -m saccot_tpu_torch.cli.main <mode>`): the run
configurations, their runners, and the file, sequence and external modes."""
