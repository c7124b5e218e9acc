"""The port's NaN guard (`utils.debug`) and profiling helpers
(`utils.profiling`) against the JAX package's (`saccot_tpu.utils.debug`,
`saccot_tpu.utils.profiling`).

Both guards get the same NumPy inputs and must reach the same verdict:
raise FloatingPointError or not. The JAX side runs on the CPU as the JAX
tests run it; its jitted functions are checked on their outputs, its
op-by-op calls op by op, and the port runs op by op.
"""

import json
import re
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saccot_tpu.engine.sac_cot import register_batch as jregister_batch
from saccot_tpu.engine.svd3 import umeyama as jumeyama
from saccot_tpu.utils.debug import nan_guard as jnan_guard
from saccot_tpu.utils.params import SacCotParams as JaxSacCotParams
from saccot_tpu.utils.profiling import StageTimer as JStageTimer
from saccot_tpu_torch import SacCotParams, register_batch
from saccot_tpu_torch.kernels import solve3 as ksolve
from saccot_tpu_torch.utils import debug
from saccot_tpu_torch.utils.convert import problem_batch
from saccot_tpu_torch.utils.debug import nan_guard
from saccot_tpu_torch.utils.profiling import StageTimer, block_until_ready, is_warm_up, trace

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
BENCH = dict(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=256,
             neighbors_per_anchor=12, max_hypotheses=1024)
FAST = dict(dedup_triangles=False, approx_topk=True, per_anchor_candidates=4)


def _verdict(guard, fn) -> bool:
    """True when fn raises FloatingPointError under the guard."""
    try:
        with guard():
            fn()
    except FloatingPointError:
        return True
    return False


def _ready(fn):
    """fn, waiting for its JAX result."""
    return lambda: jax.block_until_ready(fn())


def _nan_points():
    """P, Q [2, 40, 3] with point 7 of pair 0 set to NaN, and triples that
    name it (pair 0) and triples that do not."""
    rng = np.random.default_rng(5)
    P = rng.normal(size=(2, 40, 3)).astype(np.float32)
    Q = rng.normal(size=(2, 40, 3)).astype(np.float32)
    P[0, 7, 1] = np.nan
    named = np.array([[[7, 1, 2], [3, 4, 5]], [[7, 1, 2], [3, 4, 5]]], np.int64)
    clear = np.array([[[0, 1, 2], [3, 4, 5]], [[0, 1, 2], [3, 4, 5]]], np.int64)
    return P, Q, named, clear


def _jax_solve(P, Q, tri):
    """The JAX estimator's plain solve (`_register_pair`'s gather and
    Umeyama), jitted, over the batch."""
    return jax.jit(jax.vmap(lambda p, q, t: jumeyama(p[t], q[t])))(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(tri))


X = np.array([1.0, np.nan, 3.0], np.float32)
Z = np.zeros(3, np.float32)
POS = np.array([-1.0, 2.0, 3.0], np.float32)
NP = _nan_points()
# name: (JAX call, port call, the verdict both must reach)
CASES = {
    "an op writes a NaN": (lambda: jnp.asarray(Z) / jnp.asarray(Z),
                           lambda: torch.from_numpy(Z) / torch.from_numpy(Z), True),
    "an op on a NaN input": (lambda: jnp.asarray(X) + 1.0,
                             lambda: torch.from_numpy(X) + 1.0, True),
    "a masked log, op by op": (lambda: jnp.where(jnp.asarray(POS) > 0,
                                                 jnp.log(jnp.asarray(POS)), 0.0),
                               lambda: torch.where(torch.from_numpy(POS) > 0,
                                                   torch.log(torch.from_numpy(POS)), 0.0),
                               True),
    "clean ops": (lambda: jnp.asarray(POS) * 2.0 + 1.0,
                  lambda: torch.from_numpy(POS) * 2.0 + 1.0, False),
    "empty buffers": (lambda: jnp.empty((4096,)),
                      lambda: [torch.empty(4096), torch.empty_like(torch.from_numpy(X)),
                               torch.empty_strided((64, 64), (64, 1)),
                               torch.from_numpy(POS).new_empty((4096,))], False),
    "a NaN point through the plain solve": (
        lambda: _jax_solve(NP[0], NP[1], NP[2]),
        lambda: ksolve.solve3(torch.from_numpy(NP[0]), torch.from_numpy(NP[1]),
                              torch.from_numpy(NP[2])), True),
    "a NaN point no triple names": (
        lambda: _jax_solve(NP[0], NP[1], NP[3]),
        lambda: ksolve.solve3(torch.from_numpy(NP[0]), torch.from_numpy(NP[1]),
                              torch.from_numpy(NP[3])), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nan_guard_reaches_the_jax_verdict(case):
    jfn, tfn, want = CASES[case]
    assert _verdict(jnan_guard, _ready(jfn)) == want
    assert _verdict(nan_guard, tfn) == want
    # Outside a guard nothing raises.
    tfn()
    assert not debug._enabled


@pytest.mark.parametrize("case", ["an op writes a NaN", "a NaN point through the plain solve"])
def test_nested_false_disables_both_guards(case):
    jfn, tfn, _ = CASES[case]
    with jnan_guard():
        assert not _verdict(lambda: jnan_guard(False), _ready(jfn))
    with nan_guard():
        assert not _verdict(lambda: nan_guard(False), tfn)
        assert debug._enabled
        # The outer guard is back on after the inner scope.
        with pytest.raises(FloatingPointError):
            tfn()
    assert not debug._enabled


def test_the_error_names_the_op_and_the_plain_solve():
    P, Q, named, _ = _nan_points()
    with nan_guard(), pytest.raises(FloatingPointError) as e:
        ksolve.solve3_reference(torch.from_numpy(P), torch.from_numpy(Q),
                                torch.from_numpy(named))
    assert re.search(r"invalid value \(nan\) encountered in aten\.\w+.*solve3_reference",
                     str(e.value))
    assert not debug._enabled


def test_register_batch_runs_clean_in_both_guards():
    """The estimator on clean bench-point inputs (2 pairs, N=1,000, fast
    and exact): no raise in either package, and the port's guarded result
    has the unguarded bits."""
    P, Q, _ = problem_batch(range(1000, 1002), device="cpu", n=1000, outlier_ratio=0.8,
                            noise=0.004)
    for extra in (FAST, {}):
        jp, tp = JaxSacCotParams(**BENCH, **extra), SacCotParams(**BENCH, **extra)
        with jnan_guard():
            jax.block_until_ready(jregister_batch(jnp.asarray(P.numpy()),
                                                  jnp.asarray(Q.numpy()), jp))
        ref = register_batch(P, Q, tp)
        with nan_guard():
            got = register_batch(P, Q, tp)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_kernel_check_tests_a_flag_only_while_off(monkeypatch):
    """`check_kernel` raises on a NaN output under a guard, naming the
    kernel, and outside one looks at no data."""
    bad = torch.tensor([1.0, float("nan")])
    with nan_guard(), pytest.raises(FloatingPointError, match="kernel solve3"):
        debug.check_kernel("solve3", torch.ones(2), bad)
    with nan_guard():
        debug.check_kernel("solve3", torch.ones(2), torch.zeros(2, dtype=torch.int32))

    def touched(*_):
        raise AssertionError("the outputs were tested with no guard on")

    monkeypatch.setattr(debug, "_has_nan", touched)
    debug.check_kernel("solve3", bad)
    with nan_guard(), nan_guard(False):
        debug.check_kernel("solve3", bad)


def test_every_kernel_launch_is_checked():
    """Each kernel wrapper calls `debug.check_kernel` right after it counts
    its launch."""
    sites = 0
    for f in sorted((REPO / "saccot_tpu_torch" / "kernels").glob("*.py")):
        lines = f.read_text().splitlines()
        for i, line in enumerate(lines):
            if re.search(r"_build\.LAUNCHES\[.*\] \+= 1", line):
                sites += 1
                assert "debug.check_kernel(" in lines[i + 1], f"{f.name}:{i + 1}"
    assert sites == 11


def test_stage_timer_accumulates_as_the_jax_timer():
    jt, tt = JStageTimer(), StageTimer()
    for _ in range(2):
        for timer, arr in ((jt, jnp.ones(3)), (tt, torch.ones(3))):
            for name, sleep in (("a", 0.01), ("b", 0.02)):
                with timer.stage(name, block_on=[arr]):
                    time.sleep(sleep)
    with tt.stage("c"):
        pass
    with jt.stage("c"):
        pass
    assert list(tt.timings) == list(jt.timings) == ["a", "b", "c"]
    for t in (jt, tt):
        assert 0.02 <= t.timings["a"] < t.timings["b"] and t.timings["b"] >= 0.04
        assert 0.0 <= t.timings["c"] < 0.01
    out = {"x": torch.ones(2), "y": [torch.zeros(1), 3]}
    assert block_until_ready(out) is out


def test_trace_writes_a_chrome_trace_with_the_range(tmp_path):
    with trace(str(tmp_path / "logs")) as path:
        with torch.profiler.record_function("saccot/test_range"):
            torch.ones(64) @ torch.ones(64)
    assert path.parent == tmp_path / "logs" and path.name.endswith(".pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "saccot/test_range" for e in events)
    # A scope that raises still writes its trace.
    with pytest.raises(ValueError), trace(str(tmp_path / "logs")) as path2:
        raise ValueError("inside")
    assert path2.exists() and path2 != path


def test_profile_rows_go_through_the_one_profiler_and_drop_its_warm_up():
    """`utils.profile` captures through `profiling.profiler` (a CPU capture
    here: no card, no warm-up) and leaves the warm-up's spin-kernel records
    out of the kernel rows it sums."""
    from types import SimpleNamespace

    from saccot_tpu_torch.utils import profile as uprofile

    rows = uprofile.profiler_rows(lambda: torch.ones(64) @ torch.ones(64), 2)
    assert any(r.key == "aten::matmul" and r.count == 2 for r in rows)
    assert not any(r.key == "profiler/warm_up" for r in rows)
    cuda = torch.autograd.DeviceType.CUDA
    kernel = SimpleNamespace(device_type=cuda, is_user_annotation=False,
                             self_device_time_total=5.0,
                             key="void (anonymous namespace)::score_kernel(float const*)")
    spin = SimpleNamespace(device_type=cuda, is_user_annotation=False,
                           self_device_time_total=3.0,
                           key="at::cuda::(anonymous namespace)::spin_kernel(long)")
    assert is_warm_up(spin.key) and not is_warm_up(kernel.key)
    assert uprofile._kernel_rows([kernel, spin]) == [kernel]


@needs_cuda
def test_nan_point_through_the_solve_kernel_raises_on_card():
    P, Q, named, clear = _nan_points()
    args = [torch.from_numpy(x).cuda() for x in (P, Q)]
    with nan_guard():
        ksolve.solve3(*args, torch.from_numpy(clear).cuda())
        with pytest.raises(FloatingPointError, match="kernel solve3"):
            ksolve.solve3(*args, torch.from_numpy(named).cuda())

