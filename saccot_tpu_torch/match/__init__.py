"""Descriptor matching (port of `saccot_tpu/match`)."""
