"""Tiny cells for the CPU tests: the real cells' files, shrunk so that a
run on the CPU takes about a second (fewer and smaller pairs, a smaller
pool), driven through the program's plain route."""

import dataclasses
import functools
import json

from regbench import harness

# Points a pair, anchors and hypotheses of each tiny cell.
SIZES = {"kitti.sweep": (600, 32, 128), "threedmatch.sweep": (300, 32, 128)}


def tiny_cell(name: str, pairs: int = 4) -> harness.Cell:
    cell = harness.load_cell(name)
    n, anchors, hypotheses = SIZES[name]
    cfg = json.loads(json.dumps(cell.config))
    cfg["n"] = n
    cfg["params"].update(num_anchors=anchors, max_hypotheses=hypotheses)
    traffic = dict(cell.traffic, pairs_per_call=pairs, distinct_batches=2, warm_calls=2,
                   trace_calls=2)
    spec = dict(cell.spec, sample_pairs=4, reference_block=2)
    return dataclasses.replace(cell, config=cfg, traffic=traffic, spec=spec)


def plain():
    """The program's estimator on its plain route."""
    from saccot_tpu_torch.engine.sac_cot import register_batch
    return functools.partial(register_batch, impl="plain")
