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


def test_slam_copies_match_the_jax_package():
    """The copies of this slice: `log_so3`, `exp_se3`, `inv_T`, `ate`,
    `relative_pose_error`, `slam_sequence` and `propose_loop_candidates`
    are the originals character for character and give their arrays; the
    host-side `correspondences_to_ba` gives the original's arrays and
    stats."""
    import inspect

    from saccot_tpu.slam import frontend as jfrontend
    from saccot_tpu_torch.slam import frontend as tfrontend
    from saccot_tpu_torch.utils import se3np as tse3np

    for j, t in ((jse3np.log_so3, tse3np.log_so3), (jse3np.exp_se3, tse3np.exp_se3),
                 (jse3np.inv_T, tse3np.inv_T), (jmetrics.ate, tmetrics.ate),
                 (jmetrics.relative_pose_error, tmetrics.relative_pose_error),
                 (jsynthetic.slam_sequence, tsynthetic.slam_sequence),
                 (jfrontend.propose_loop_candidates, tfrontend.propose_loop_candidates)):
        assert inspect.getsource(j) == inspect.getsource(t), j.__name__
    rng = np.random.default_rng(4)
    xi = rng.normal(scale=0.6, size=(20, 6))
    np.testing.assert_array_equal(tse3np.exp_se3(xi), jse3np.exp_se3(xi))
    T = jse3np.exp_se3(xi)
    np.testing.assert_array_equal(tse3np.inv_T(T), jse3np.inv_T(T))
    np.testing.assert_array_equal(tse3np.log_so3(T[:, :3, :3]), jse3np.log_so3(T[:, :3, :3]))
    for seed in range(3):
        for kw in ({}, dict(n_scans=7, n_corr=64, loop_every=3, n_world=900, noise=0.002)):
            a = jsynthetic.slam_sequence(seed=seed, **kw)
            b = tsynthetic.slam_sequence(seed=seed, **kw)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
    seq = jsynthetic.slam_sequence(seed=1, n_scans=9, n_corr=48, loop_every=3, n_world=600)
    est = seq["poses_gt"] @ jse3np.exp_se3(rng.normal(scale=0.02, size=(9, 6)))
    assert tmetrics.ate(est, seq["poses_gt"]) == jmetrics.ate(est, seq["poses_gt"])
    assert tmetrics.ate(est, seq["poses_gt"], align=False) == \
        jmetrics.ate(est, seq["poses_gt"], align=False)
    assert tmetrics.relative_pose_error(est, seq["poses_gt"], 2) == \
        jmetrics.relative_pose_error(est, seq["poses_gt"], 2)
    np.testing.assert_array_equal(
        tfrontend.propose_loop_candidates(est, min_gap=2, radius=2.0),
        jfrontend.propose_loop_candidates(est, min_gap=2, radius=2.0))
    inl = rng.uniform(size=seq["edge_P"].shape[:2]) < 0.6
    for mode, L, G in (("tracks", 256, 4), ("pairwise", 64, 2)):
        args = (est.astype(np.float32), seq["edges"], seq["edge_P"], seq["edge_Q"], inl)
        kw = dict(max_landmarks=L, obs_per_landmark=G, merge_cell=0.2, mode=mode)
        ref, ref_stats = jfrontend.correspondences_to_ba(*args, **kw)
        got, stats = tfrontend.correspondences_to_ba(*args, device="cpu", **kw)
        assert stats == ref_stats
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slam_and_ablation_configurations_match_the_jax_package():
    """The restated slam configuration (`slam/frontend.py`) and the
    ablation's estimator parameters (`evaluation/ablation.py`) equal
    `cli/configs.py`'s "slam" and `_OBJ_PARAMS`; `run_sequence` and
    `run_sampler_ablation` keep the JAX package's defaults."""
    import inspect

    from saccot_tpu.cli.configs import _OBJ_PARAMS
    from saccot_tpu.evaluation import ablation as jablation
    from saccot_tpu.slam import frontend as jfrontend
    from saccot_tpu_torch.evaluation import ablation as tablation
    from saccot_tpu_torch.slam import frontend as tfrontend

    cfg = CONFIGS["slam"]
    assert (tfrontend.SLAM_SEED, tfrontend.SLAM_SCANS, tfrontend.SLAM_CORR,
            tfrontend.SLAM_OUTLIERS, tfrontend.SLAM_NOISE, tfrontend.SLAM_LOOP_EVERY) == \
        (cfg.seed, cfg.n_scans, cfg.n_corr, cfg.outlier_ratio, cfg.noise, cfg.loop_every)
    assert dataclasses.asdict(tfrontend.SLAM_PARAMS) == dataclasses.asdict(cfg.params)
    assert dataclasses.asdict(tablation.OBJ_PARAMS) == dataclasses.asdict(_OBJ_PARAMS)
    a = tfrontend.slam_config_sequence()
    b = jsynthetic.slam_sequence(seed=cfg.seed, n_scans=cfg.n_scans, n_corr=cfg.n_corr,
                                 outlier_ratio=cfg.outlier_ratio, noise=cfg.noise,
                                 loop_every=cfg.loop_every)
    assert a.keys() == b.keys() and len(a["edges"]) == 13
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    for j, t, port_only in ((jfrontend.run_sequence, tfrontend.run_sequence, {"impl", "device"}),
                            (jablation.run_sampler_ablation, tablation.run_sampler_ablation,
                             {"device"})):
        dj, dt = defaults(j), defaults(t)
        assert set(dt) - set(dj) == port_only
        assert {k: dt[k] for k in dj if k != "impl"} == {k: v for k, v in dj.items()
                                                          if k != "impl"}


def test_cli_slice_copies_match_the_jax_package(tmp_path):
    """The copies of the CLI slice: `model_rmse` and `model_views` give the
    originals' values and arrays; the loaders are the originals character
    for character but for the native module they name; the sweep
    checkpoint's files are one format (each package resumes from the
    other's shards); the run configurations are the JAX package's field by
    field (but for `impl`, whose values are each package's own)."""
    import inspect

    from saccot_tpu.cli import configs as jconfigs
    from saccot_tpu.io import loaders as jloaders
    from saccot_tpu.utils.checkpoint import SweepCheckpointer as JSweepCheckpointer
    from saccot_tpu_torch.cli import configs as tconfigs
    from saccot_tpu_torch.io import loaders as tloaders
    from saccot_tpu_torch.utils.checkpoint import SweepCheckpointer

    rng = np.random.default_rng(11)
    model = rng.normal(size=(300, 3))
    for s in range(4):
        T_est = jse3np.random_transform(rng, max_angle_rad=0.15 + 0.05 * s, max_trans=0.02 * s)
        T_gt = jse3np.random_transform(rng)
        assert tmetrics.model_rmse(T_est @ T_gt, T_gt, model) == \
            jmetrics.model_rmse(T_est @ T_gt, T_gt, model)
    for seed, kw in ((0, {}), (3, dict(n_views=5, n_points=700, cap_frac=0.4, noise=0.01))):
        a = jsynthetic.model_views(seed=seed, **kw)
        b = tsynthetic.model_views(seed=seed, **kw)
        assert a.keys() == b.keys()
        for k in ("T", "model"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("views", "idx"):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype

    for name in ("load_ply", "load_pcd", "load_cloud", "load_kitti_poses", "save_log",
                 "load_gt_log", "bucket_for"):
        assert inspect.getsource(getattr(jloaders, name)) == \
            inspect.getsource(getattr(tloaders, name)), name
    assert inspect.getsource(jloaders.load_kitti_bin).replace("saccot_tpu.", "saccot_tpu_torch.") \
        == inspect.getsource(tloaders.load_kitti_bin)
    assert jloaders._PLY_TYPES == tloaders._PLY_TYPES

    T = rng.normal(size=(4, 4, 4))
    JSweepCheckpointer(str(tmp_path / "j")).record(0, dict(T=T, n=np.arange(4)))
    SweepCheckpointer(str(tmp_path / "t")).record(0, dict(T=T, n=np.arange(4)))
    for cls, other in ((SweepCheckpointer, "j"), (JSweepCheckpointer, "t")):
        got = cls(str(tmp_path / other))
        assert got.is_done(0) and not got.is_done(1)
        np.testing.assert_array_equal(got.done[0]["T"], T)
        np.testing.assert_array_equal(got.merged()["n"], np.arange(4))
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        sorted(p.name for p in (tmp_path / "t").iterdir())

    def no_impl(cfg):
        d = dataclasses.asdict(cfg)
        d.pop("impl")
        if d.get("pipeline") is not None:
            d["pipeline"].pop("impl")
        return d

    assert jconfigs.CONFIGS.keys() == tconfigs.CONFIGS.keys()
    for name, cfg in jconfigs.CONFIGS.items():
        assert no_impl(tconfigs.CONFIGS[name]) == no_impl(cfg), name
        assert tconfigs.CONFIGS[name].impl == "auto"
    assert [f.name for f in dataclasses.fields(tconfigs.RunConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.RunConfig)]
    assert _fields(tconfigs.RunConfig, skip=("params", "pipeline")) == \
        _fields(jconfigs.RunConfig, skip=("params", "pipeline"))
    assert dataclasses.asdict(tconfigs._OBJ_PARAMS) == dataclasses.asdict(jconfigs._OBJ_PARAMS)
    pipe = {k: v for k, v in dataclasses.asdict(tconfigs._PIPE).items() if k != "impl"}
    assert pipe == {k: v for k, v in dataclasses.asdict(jconfigs._PIPE).items() if k != "impl"}
    assert tconfigs.estimator_impl("auto") == "kernel"
    for bad in ("jnp", "pallas"):
        with pytest.raises(ValueError):
            tconfigs.RunConfig(name="x", kind="sweep", impl=bad)
    # The restatements below the command line agree with the table.
    from saccot_tpu_torch.evaluation.ablation import OBJ_PARAMS
    from saccot_tpu_torch.slam.frontend import SLAM_PARAMS

    assert pipeline.BUNNY_PIPE == tconfigs._PIPE
    assert OBJ_PARAMS == tconfigs._OBJ_PARAMS
    assert SLAM_PARAMS == tconfigs.CONFIGS["slam"].params


def test_cli_entry_points_default_to_the_card():
    """Every runner and mode of the port's command line takes `device`,
    "cuda" by default, beside the JAX function's own defaults."""
    import inspect

    from saccot_tpu.cli import external as jexternal
    from saccot_tpu.cli import files as jfiles
    from saccot_tpu.cli import runners as jrunners
    from saccot_tpu.cli import sequence as jsequence
    from saccot_tpu.evaluation import scaling as jscaling
    from saccot_tpu_torch.cli import external, files, runners, sequence
    from saccot_tpu_torch.evaluation import scaling

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    pairs = [(getattr(jrunners, n), getattr(runners, n)) for n in (
        "run_pipeline_config", "run_sweep_config", "run_kitti_config", "run_slam_config",
        "run_u3m_allpairs_config")]
    pairs += [(jfiles.register_files, files.register_files),
              (jexternal.run_external, external.run_external),
              (jsequence.run_sequence_files, sequence.run_sequence_files),
              (jsequence.default_sequence_config, sequence.default_sequence_config)]
    for j, t in pairs:
        dj, dt = defaults(j), defaults(t)
        extra = set(dt) - set(dj)
        assert extra <= {"device"}, (t.__name__, extra)
        assert dt.get("device", "cuda") == "cuda", t.__name__
        assert {k: dt[k] for k in dj if k != "impl"} == \
            {k: v for k, v in dj.items() if k != "impl"}, t.__name__
    js, ts = defaults(jscaling.measure_scaling), defaults(scaling.measure_scaling)
    assert {k: ts[k] for k in js} == js and ts["device"] == "cuda"
    assert sequence.default_sequence_config() == dataclasses.replace(
        PipelineConfig(**{k: v for k, v in dataclasses.asdict(
            jsequence.default_sequence_config()).items() if k not in ("impl", "estimator")}),
        estimator=tparams.SacCotParams(**dataclasses.asdict(
            jsequence.default_sequence_config().estimator)))


def test_oracle_copy_matches_the_jax_package_line_for_line():
    """`saccot_tpu_torch/oracle/saccot.py` below its module docstring is
    `saccot_tpu/oracle/saccot.py` line for line, but for the one import of
    `SacCotParams`, which names the port's copy; `__init__` exports the same
    names."""
    def body(path: Path):
        src = path.read_text()
        doc = ast.parse(src).body[0]
        assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
        return src.splitlines()[doc.end_lineno:]

    jax_lines = body(REPO / "saccot_tpu" / "oracle" / "saccot.py")
    port_lines = body(REPO / "saccot_tpu_torch" / "oracle" / "saccot.py")
    assert len(port_lines) == len(jax_lines) > 200
    differ = [(a, b) for a, b in zip(jax_lines, port_lines) if a != b]
    assert differ == [("from saccot_tpu.utils.params import SacCotParams",
                       "from saccot_tpu_torch.utils.params import SacCotParams")]

    def exported(path: Path):
        tree = ast.parse(path.read_text())
        return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                for a in node.names]

    assert exported(REPO / "saccot_tpu_torch" / "oracle" / "__init__.py") == \
        exported(REPO / "saccot_tpu" / "oracle" / "__init__.py")
