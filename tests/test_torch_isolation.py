"""The port stands alone: it imports neither JAX nor the JAX package, and its
own copies of the JAX package's pure-Python helpers agree with the originals.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np

import pytest

from saccot_tpu.cli.configs import CONFIGS
from saccot_tpu.engine.icp import IcpParams as JIcpParams
from saccot_tpu.evaluation import metrics as jmetrics
from saccot_tpu.features.pipeline import PipelineConfig as JPipelineConfig
from saccot_tpu.io import synthetic as jsynthetic
from saccot_tpu.utils import params as jparams
from saccot_tpu.utils import se3np as jse3np
from saccot_tpu_torch.engine.icp import IcpParams
from saccot_tpu_torch.evaluation import metrics as tmetrics
from saccot_tpu_torch.features import pipeline
from saccot_tpu_torch.features.pipeline import PipelineConfig
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


def _fields(cls, skip=()):
    """(name, default) of a dataclass's fields; nested dataclass defaults
    as their field dicts."""
    out = []
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        d = f.default
        out.append((f.name, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d))
    return out


def test_two_view_pair_matches_the_jax_package():
    for seed in range(4):
        for kw in ({}, dict(n_points=2048, overlap=0.8, noise=0.002),
                   dict(n_points=1000, overlap=0.3, noise=0.01, max_angle=0.5, max_trans=2.0)):
            a = jsynthetic.two_view_pair(seed=seed, **kw)
            b = tsynthetic.two_view_pair(seed=seed, **kw)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype


def test_pipeline_and_icp_configs_match_the_jax_package():
    # Every field and default but `impl` (the JAX package's "jnp"/"pallas",
    # the port's "kernel"/"plain").
    assert _fields(PipelineConfig, skip=("impl",)) == _fields(JPipelineConfig, skip=("impl",))
    assert [f.name for f in dataclasses.fields(PipelineConfig)] == \
        [f.name for f in dataclasses.fields(JPipelineConfig)]
    assert _fields(IcpParams) == _fields(JIcpParams)
    # The same checks reject the same values.
    for bad in (dict(descriptor="fcgf"), dict(keypoints="sift")):
        for cls in (PipelineConfig, JPipelineConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    for bad in (dict(trim_frac=0.0), dict(trim_frac=1.5), dict(variant="line"),
                dict(max_iters=0)):
        for cls in (IcpParams, JIcpParams):
            with pytest.raises(ValueError):
                cls(**bad)
    with pytest.raises(ValueError):
        PipelineConfig(impl="pallas")


def test_bunny_configuration_matches_the_jax_package():
    """The restated bunny run configuration (`features/pipeline.py`) equals
    `cli/configs.py`'s `_PIPE` and "bunny"; the views hold exactly
    `n_points` each, so the pairs stack without padding."""
    cfg = CONFIGS["bunny"]
    want = {k: v for k, v in dataclasses.asdict(cfg.pipeline).items() if k != "impl"}
    got = {k: v for k, v in dataclasses.asdict(pipeline.BUNNY_PIPE).items() if k != "impl"}
    assert got == want
    assert pipeline.BUNNY_PIPE.impl == "kernel"
    assert (pipeline.BUNNY_SEED, pipeline.BUNNY_PAIRS, pipeline.BUNNY_N_POINTS,
            pipeline.BUNNY_OVERLAP, pipeline.BUNNY_CRITERION) == \
        (cfg.seed, cfg.n_pairs, cfg.n_points, cfg.overlap, (cfg.rot_thresh_deg, cfg.trans_thresh))
    # run_pipeline_config draws its pairs with noise 0.002 (cli/runners.py).
    assert pipeline.BUNNY_NOISE == 0.002
    src, tgt, T_gt = pipeline.bunny_pairs([9, 10], device="cpu", n_points=1024)
    for b, seed in enumerate((9, 10)):
        pair = jsynthetic.two_view_pair(seed=seed, n_points=1024, overlap=cfg.overlap, noise=0.002)
        np.testing.assert_array_equal(src[b].numpy(), pair["source"])
        np.testing.assert_array_equal(tgt[b].numpy(), pair["target"])
        np.testing.assert_array_equal(T_gt[b], pair["T_gt"])
