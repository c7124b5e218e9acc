"""One process, no process group: `init_distributed` joins nothing and
`make_mesh` gives the one-rank mesh, which the sweep accepts. Run in a
subprocess with the rank variables removed, as a plain `python` is."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BODY = r"""
import json
import torch
import torch.distributed as dist
from saccot_tpu_torch import register_batch
from saccot_tpu_torch.dist.mesh import (
    AXES, axis_group, axis_size, init_distributed, local_batch_size, make_mesh)
from saccot_tpu_torch.dist.sweep import make_sweep_fn, run_sweep
from saccot_tpu_torch.utils.convert import problem_batch
from saccot_tpu_torch.utils.params import SacCotParams

torch.set_num_threads(1)
out = {"backend": init_distributed(), "joined": dist.is_initialized()}
mesh = make_mesh()
out["sizes"] = [axis_size(mesh, a) for a in AXES]
out["groups"] = [axis_group(mesh, a) for a in AXES]
out["local_batch"] = local_batch_size(2, mesh)
try:
    make_mesh(corr=2)
except ValueError:
    out["corr2"] = "ValueError"
params = SacCotParams(num_anchors=32, neighbors_per_anchor=8, max_hypotheses=64)
P, Q, _ = problem_batch([3, 4], device="cpu", n=128, outlier_ratio=0.5)
got = run_sweep(make_sweep_fn(mesh, params, impl="plain"), P, Q)
want = register_batch(P, Q, params, impl="plain")
out["equal"] = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
out["inliers"] = got.num_inliers.tolist()
print(json.dumps(out))
"""


def test_one_process_init_and_mesh_feed_the_sweep():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    run = subprocess.run([sys.executable, "-c", BODY], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["backend"] is None and not out["joined"]
    assert out["sizes"] == [1, 1, 1] and out["groups"] == [None, None, None]
    assert out["local_batch"] == 2 and out["corr2"] == "ValueError"
    assert all(out["equal"]) and len(out["equal"]) == 8
    assert min(out["inliers"]) > 30


def test_make_mesh_without_group_under_a_larger_world_raises():
    env = dict(os.environ, WORLD_SIZE="2")
    env.pop("RANK", None)
    run = subprocess.run(
        [sys.executable, "-c", "from saccot_tpu_torch.dist.mesh import make_mesh; make_mesh()"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert run.returncode != 0 and "init_distributed" in run.stderr


def test_explicit_single_process_joins_nothing(monkeypatch):
    """`num_processes=1` joins nothing, as the JAX package's does, even where
    the environment names a larger world (whose missing RANK would raise)."""
    import torch.distributed as dist

    from saccot_tpu_torch.dist.mesh import init_distributed

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    assert init_distributed(num_processes=1) is None
    assert init_distributed("127.0.0.1:29500", num_processes=1, process_id=0) is None
    assert not dist.is_initialized()
