"""Faults planted in the timed path, for the checks that `correct` comes out
false when the program is broken underneath.

`FAULTS[name](register)` wraps an estimator `register(P, Q, params,
mask=None)` (the program's `register_batch` on one route) into one with the
fault. A fault inside a stage is planted by replacing that stage's function
in the program's module for the length of the call, on both routes, so the
same fault runs on the card (kernel route) and in the CPU tests (plain
route):

- refine_returns_its_state: the refine's steps hand back the best
  hypothesis as they got it;
- half_the_batch_left_out: the first half of the batch registered, the rest
  of each output left as allocated (zeros);
- rotation_altered_where_produced: each pair's rotation written transposed;
- degrees_zeroed: every compatibility degree 0, so the anchors are the
  first rows;
- degrees_permuted: each correspondence given its neighbour's degree;
- pool_half_the_anchors: the pool built from the first half of its anchors;
- solve_rotations_transposed: each hypothesis's rotation written
  transposed by the 3-point solve;
- score_skips_a_tile: the hypotheses scored over the first 7/8 of the
  points only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Callable, Dict
from unittest import mock

import torch


def _in_stage(module: str, names, wrap) -> Callable:
    """A fault that replaces `module.<name>` for each of `names` by
    wrap(original) while the estimator runs."""
    def fault(register):
        def run(P, Q, params, mask=None):
            mod = importlib.import_module(module)
            with contextlib.ExitStack() as stack:
                for name in names:
                    stack.enter_context(mock.patch.object(mod, name, wrap(getattr(mod, name))))
                return register(P, Q, params, mask=mask)
        return run
    return fault


def _degrees(change):
    return _in_stage("saccot_tpu_torch.kernels.compat", ("degrees", "degrees_reference"),
                     lambda f: lambda *a, **k: change(f(*a, **k)))


def _half_the_anchors(f):
    def pool(P, Q, deg, params, *a, **k):
        return f(P, Q, deg, dataclasses.replace(params, num_anchors=params.num_anchors // 2),
                 *a, **k)
    return pool


def _skip_a_tile(f):
    def score(r9, t3, P, Q, tau, mask=None, *a, **k):
        batch, n = P.shape[:2]
        keep = (torch.arange(n, device=P.device) < n - n // 8).to(torch.float32)
        keep = keep.expand(batch, n).contiguous()
        return f(r9, t3, P, Q, tau, keep if mask is None else mask * keep, *a, **k)
    return score


def _transposed(f):
    def solve(*a, **k):
        r9, t3 = f(*a, **k)
        batch, _, K = r9.shape
        return r9.reshape(batch, 3, 3, K).transpose(1, 2).reshape(batch, 9, K), t3
    return solve


def refine_returns_its_state(register):
    def run(P, Q, params, mask=None):
        return register(P, Q, dataclasses.replace(params, refine_iters=0), mask=mask)
    return run


def half_the_batch_left_out(register):
    def run(P, Q, params, mask=None):
        batch, h = P.shape[0], P.shape[0] // 2
        part = register(P[:h], Q[:h], params, mask=None if mask is None else mask[:h])
        return type(part)(*(torch.cat([x, x.new_zeros((batch - h, *x.shape[1:]))])
                            for x in part))
    return run


def rotation_altered_where_produced(register):
    def run(P, Q, params, mask=None):
        res = register(P, Q, params, mask=mask)
        return res._replace(R=res.R.transpose(1, 2).contiguous())
    return run


# Faults that change which triangles the pool holds but, where every good
# hypothesis counts nearly every true inlier, no output beyond a count or two:
# read on the card at a cell's own size (`python -m regbench.control`); at
# the CPU tests' tiny sizes every output is the reference's under them.
SELECTION = ("degrees_zeroed", "degrees_permuted", "pool_half_the_anchors")

FAULTS: Dict[str, Callable] = {
    "refine_returns_its_state": refine_returns_its_state,
    "half_the_batch_left_out": half_the_batch_left_out,
    "rotation_altered_where_produced": rotation_altered_where_produced,
    "degrees_zeroed": _degrees(torch.zeros_like),
    "degrees_permuted": _degrees(lambda d: torch.roll(d, 1, dims=1)),
    "pool_half_the_anchors": _in_stage("saccot_tpu_torch.engine.triangles",
                                       ("triangle_pool_from_points",), _half_the_anchors),
    "solve_rotations_transposed": _in_stage("saccot_tpu_torch.kernels.solve3",
                                            ("solve3", "solve3_reference"), _transposed),
    "score_skips_a_tile": _in_stage("saccot_tpu_torch.kernels.score",
                                    ("score_hypotheses", "score_hypotheses_reference"),
                                    _skip_a_tile),
}
