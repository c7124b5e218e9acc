"""Helpers of the command-line tests (tests/test_torch_cli.py,
tests/test_torch_cli_files.py): the port's `main` on the CPU, the JAX
pipeline entry points run op by op, and the transform tolerance."""

import json

import numpy as np

from saccot_tpu.features import pipeline as jpipe
from saccot_tpu_torch.cli.main import main
from saccot_tpu_torch.utils import se3np

# tests/test_torch_pipeline.py's tolerance on T against the JAX package's.
ROT_DEG, TRANS = 0.1, 1e-3


def jax_register_clouds(src, tgt, cfg, src_mask=None, tgt_mask=None):
    return jpipe._register_clouds(src, tgt, cfg, src_mask, tgt_mask)


def jax_op_by_op(monkeypatch, module):
    """Point a JAX CLI module's pipeline entry points at their unjitted
    bodies, as tests/test_torch_pipeline.py runs them: a jitted JAX program
    fuses multiply-adds and moves its own keypoint counts."""
    for name, fn in (("register_clouds", jax_register_clouds),
                     ("extract_scan_features", jpipe.extract_scan_features.__wrapped__),
                     ("register_scan_features", jpipe.register_scan_features.__wrapped__)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, fn)


def run_main(args, capsys):
    """The port's `main(args + ["--cpu"])` in this process; its JSON line."""
    assert main(args + ["--cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_T_close(T_a, T_b, what):
    E = np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64))
    rot, trans = se3np.rotation_angle_deg(E[:3, :3]), float(np.linalg.norm(E[:3, 3]))
    assert rot < ROT_DEG and trans < TRANS, (what, rot, trans)
