"""Run one cell of the benchmark once and print its result line.

    python -m regbench.run --workload kitti.sweep --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with the cell's cards. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`compared`, each number of the comparison beside its limit (also the last
lines of standard error). Exits non-zero, printing no result, without
enough CUDA cards, or when JAX or the JAX package was loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "saccot_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from regbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"regbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    detail = {}
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, PROCESS_START,
                         detail=detail)
    print("setup steps (s from the start): " + json.dumps(detail["setup_steps"])
          + f"; window {detail['window'].seconds:.3f} s, {len(detail['window'].calls)} calls;"
          + f" reference {detail['reference_s']:.3f} s", file=sys.stderr)

    bad = forbidden_modules()
    if bad:
        print(f"regbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
