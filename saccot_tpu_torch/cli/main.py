"""Command line: `python -m saccot_tpu_torch.cli.main <mode> [options]`
(port of `saccot_tpu/cli/main.py`).

Pick a run configuration or a file mode, run it, and print the metrics as
one JSON line on stdout (diagnostics to stderr, per-pair records to --log
as JSONL). The run is on the card; --cpu runs it on the CPU instead, where
every kernel takes its plain PyTorch version. Without a card and without
--cpu the command fails rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from saccot_tpu_torch.cli.configs import CONFIGS
from saccot_tpu_torch.dist.mesh import init_distributed
from saccot_tpu_torch.utils.logging import JsonlLogger


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="saccot_tpu_torch", description=__doc__)
    ap.add_argument(
        "config",
        choices=sorted(CONFIGS) + ["files", "sequence", "ablate", "external"],
        help="run configuration, 'files' to register two cloud files, "
             "'sequence' to run odometry over a directory of scans, "
             "'ablate' for the paper-style sampler comparison "
             "(random / edge-guided / triangle-guided at equal budgets), or "
             "'external' for the real-3DMatch protocol (per-fragment .npz "
             "descriptors + gt.log -> RE/TE recall)",
    )
    ap.add_argument("--src", type=str, default=None, help="source cloud file (files mode)")
    ap.add_argument("--tgt", type=str, default=None, help="target cloud file (files mode)")
    ap.add_argument("--dir", type=str, default=None,
                    help="scan directory or comma-separated files (sequence mode); "
                         "fragment directory (external mode)")
    ap.add_argument("--fmt", choices=["kitti", "ply"], default="kitti",
                    help="scan format (sequence mode)")
    ap.add_argument("--poses", type=str, default=None,
                    help="KITTI-format ground-truth poses (sequence mode)")
    ap.add_argument("--stride", type=int, default=1, help="scan stride (sequence mode)")
    ap.add_argument("--loops", action="store_true",
                    help="propose + confirm loop closures and optimize the "
                         "robust pose graph (sequence mode)")
    ap.add_argument("--descriptor", choices=["shot", "fpfh"], default="shot")
    ap.add_argument("--gt", type=str, default=None,
                    help="optional 4x4 ground-truth transform (whitespace text) to evaluate against")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=None, help="override pair count")
    ap.add_argument("--scans", type=int, default=None, help="override scan count (slam)")
    ap.add_argument("--views", type=int, default=None,
                    help="override view count (u3m all-pairs sweep)")
    ap.add_argument("--corr", type=int, default=None, help="override correspondence count")
    ap.add_argument("--log", type=str, default=None, help="JSONL per-pair log path")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint: a shard directory (threedmatch), a state file (slam)")
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per estimator call for the sweep configs (default 16)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) instead of the card")
    ap.add_argument("--icp", action="store_true",
                    help="dense trimmed-ICP polish after the estimator "
                         "(pipeline configs: bunny, u3m)")
    ap.add_argument("--outliers", type=str, default="0.8,0.9,0.95",
                    help="comma-separated outlier ratios (ablate mode)")
    ap.add_argument("--budget", type=int, default=512,
                    help="sample budget K shared by all samplers (ablate mode)")
    ap.add_argument("--fail-after-shard", type=int, default=None,
                    help="fault injection: exit with code 17 after checkpointing this shard")
    ap.add_argument("--gt-log", type=str, default=None,
                    help="3DMatch-style gt.log of ground-truth pair transforms "
                         "(external mode)")
    ap.add_argument("--max-corr", type=int, default=2048,
                    help="correspondence cap per pair (external mode)")
    ap.add_argument("--out-log", type=str, default=None,
                    help="write estimated transforms as a 3DMatch-style .log "
                         "(external mode; read by the standard Redwood/3DMatch "
                         "evaluation scripts)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)

    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        print("saccot_tpu_torch: no CUDA device; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 2

    init_distributed()
    log = JsonlLogger(args.log) if args.log else None
    try:
        print(json.dumps(run(ap, args, device, {} if log is None else {"log": log})))
    finally:
        if log is not None:
            log.close()
    return 0


def run(ap, args, device, kw):
    """The metrics of the mode `args` name, on `device`."""
    if args.config == "files":
        from saccot_tpu_torch.cli.files import register_files

        if not args.src or not args.tgt:
            ap.error("files mode requires --src and --tgt")
        return register_files(args.src, args.tgt, descriptor=args.descriptor,
                              gt_path=args.gt, device=device)

    if args.config == "external":
        from saccot_tpu_torch.cli import external

        if not args.dir or not args.gt_log:
            ap.error("external mode requires --dir and --gt-log")
        return external.run_external(
            args.dir, args.gt_log, max_correspondences=args.max_corr,
            out_log=args.out_log, device=device, **kw
        )

    if args.config == "sequence":
        from saccot_tpu_torch.cli.sequence import run_sequence_files

        if not args.dir:
            ap.error("sequence mode requires --dir")
        metrics = run_sequence_files(
            args.dir, fmt=args.fmt, poses_path=args.poses, stride=args.stride,
            loops=args.loops, device=device, **kw
        )
        metrics.pop("trajectory", None)  # keep the stdout JSON line compact
        return metrics

    if args.config == "ablate":
        from saccot_tpu_torch.cli.configs import _OBJ_PARAMS
        from saccot_tpu_torch.evaluation.ablation import format_table, run_sampler_ablation

        params = dataclasses.replace(_OBJ_PARAMS, max_hypotheses=args.budget)
        res = run_sampler_ablation(
            params,
            outlier_ratios=tuple(float(x) for x in args.outliers.split(",")),
            n_pairs=args.pairs or 32,
            n_corr=args.corr or 1000,
            seed=args.seed or 0,
            impl="kernel",
            device=device,
        )
        print(format_table(res), file=sys.stderr)
        return {"recall": {s: {str(k): v for k, v in row.items()}
                           for s, row in res["recall"].items()},
                "budget": res["budget"]}

    from saccot_tpu_torch.cli.runners import run_config

    cfg = CONFIGS[args.config]
    overrides = {}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.pairs is not None:
        overrides["n_pairs"] = args.pairs
    if args.scans is not None:
        overrides["n_scans"] = args.scans
    if args.corr is not None:
        overrides["n_corr"] = args.corr
    if args.views is not None:
        overrides["n_views"] = args.views
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.icp:
        if cfg.pipeline is None:
            ap.error(f"--icp applies to pipeline configs, not {cfg.name!r}")
        from saccot_tpu_torch.engine.icp import IcpParams

        cfg = dataclasses.replace(
            cfg,
            pipeline=dataclasses.replace(
                cfg.pipeline,
                icp=IcpParams(max_iters=10, max_corr_dist=6.0, trim_frac=0.8),
            ),
        )

    if args.ckpt and cfg.kind in ("sweep", "slam"):
        kw["ckpt"] = args.ckpt
    if args.fail_after_shard is not None and cfg.kind == "sweep":
        kw["fail_after_shard"] = args.fail_after_shard
    if args.batch is not None and cfg.kind == "sweep":
        kw["batch"] = args.batch

    return run_config(cfg, device=device, **kw)


if __name__ == "__main__":
    sys.exit(main())
