"""The port stands alone: it imports neither JAX nor the JAX package, and its
own copies of the JAX package's pure-Python helpers agree with the originals.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np

from saccot_tpu.evaluation import metrics as jmetrics
from saccot_tpu.io import synthetic as jsynthetic
from saccot_tpu.utils import params as jparams
from saccot_tpu.utils import se3np as jse3np
from saccot_tpu_torch.evaluation import metrics as tmetrics
from saccot_tpu_torch.io import synthetic as tsynthetic
from saccot_tpu_torch.utils import params as tparams

REPO = Path(__file__).resolve().parents[1]


def _imported_modules(path: Path):
    """Every module name an import statement of the file names, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "saccot_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "saccot_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_copies_match_the_jax_package():
    # SacCotParams: the same fields, defaults and checks.
    jf = [(f.name, f.default) for f in dataclasses.fields(jparams.SacCotParams)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tparams.SacCotParams)]
    assert jf == tf and "ring_compat" in dict(tf)
    some = dict(num_anchors=64, neighbors_per_anchor=10, dedup_triangles=False,
                per_anchor_candidates=4, compat_tau=0.3)
    assert (tparams.num_candidate_triangles(tparams.SacCotParams(**some))
            == jparams.num_candidate_triangles(jparams.SacCotParams(**some)))
    assert (dataclasses.asdict(tparams.SacCotParams(**some).with_scale(0.5))
            == dataclasses.asdict(jparams.SacCotParams(**some).with_scale(0.5)))
    # correspondence_problem: identical arrays, also with the kitti arguments.
    kitti = dict(n=400, outlier_ratio=0.7, noise=0.05 / 30.0, n_points=1600, max_angle=0.3,
                 max_trans=3.0)
    for seed in range(5):
        for kw in ({}, dict(n=300, outlier_ratio=0.8, noise=0.004), kitti):
            a = jsynthetic.correspondence_problem(seed=seed, **kw)
            b = tsynthetic.correspondence_problem(seed=seed, **kw)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    # registration_recall and its parts on transforms near and far from the truth.
    rng = np.random.default_rng(3)
    pairs = [(jse3np.random_transform(rng, max_angle_rad=s, max_trans=s) @ g, g)
             for s, g in ((0.05 * (i % 7) + 0.11, jse3np.random_transform(rng))
                          for i in range(40))]
    for rot, trans in ((15.0, 0.30), (5.0, 0.6), (5.0, 0.05)):
        want = jmetrics.registration_recall(pairs, rot, trans)
        assert tmetrics.registration_recall(pairs, rot, trans) == want
    assert 0.0 < jmetrics.registration_recall(pairs, 15.0, 0.30) < 1.0
    for e, g in pairs[:5]:
        assert tmetrics.registration_error(e, g) == jmetrics.registration_error(e, g)
