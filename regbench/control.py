"""The readings that a cell's limits are set from, on the card.

    python -m regbench.control --workload kitti.sweep --seeds 11 12 13 \
        --control-seeds 21 22 23 --faults degrees_zeroed --fault-seeds 31 32 33 \
        --seconds 3

Lower readings: for each of `--seeds`, one run of the program as the
benchmark makes it (set-up, a window of `--seconds` at the cell's own load,
the comparison of a sample drawn from the seed), and its compared numbers.
Upper readings: for each of `--control-seeds`, the control: the reference
in bfloat16, the precision below the configuration's float32, put in the
program's place on the same sample of the same problems and compared with
the float32 reference by the same numbers. Fault readings: for each of
`--faults` (names of `faults.FAULTS`) and each of `--fault-seeds`, a run as
above with that fault planted in the program, and whether it came out
correct. One JSON line a reading on standard output, then the largest lower
and the smallest upper reading of each number, and the smallest reading of
each number under each fault.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def control_numbers(cell, seed: int, device) -> dict:
    """The control's compared numbers on the sample a run with `seed` draws
    (from the calls of its distinct batches)."""
    import torch

    from regbench import compare, generate
    from regbench.reference import saccot as reference

    batches = generate.cell_batches(seed, cell.config, cell.traffic, device=device)
    batch = int(cell.traffic["pairs_per_call"])
    sample = compare.draw_sample(seed, len(batches), batch, int(cell.spec["sample_pairs"]))

    def pick(k):
        if batches[0][k] is None:
            return None
        return torch.stack([batches[c][k][p] for c, p in sample]).clone()

    P, Q, mask = pick(0), pick(1), pick(3)
    del batches
    prm, block = cell.config["params"], int(cell.spec["reference_block"])
    ref = compare.run_reference(reference.register, P, Q, mask, prm, block)
    low = compare.run_reference(reference.register, P, Q, mask, prm, block,
                                dtype=torch.bfloat16)
    return compare.gaps(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from regbench import compare, faults, harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    lower, upper = {}, {}
    for seed in args.seeds:
        detail = {}
        res = harness.run(cell, seed, args.seconds, False, device, PROCESS_START, detail=detail)
        nums = compare.gaps(detail["got"], detail["ref"])
        ref = detail["ref"]
        print(json.dumps(dict(kind="program", seed=seed, correct=res["correct"],
                              attempted=res["attempted"], failed=res["failed"],
                              metrics=res["metrics"], numbers=nums,
                              reference_s=detail["reference_s"],
                              inliers=[int(ref["num_inliers"].min()),
                                       int(ref["num_inliers"].max())],
                              best_score=[float(ref["best_score"].min()),
                                          float(ref["best_score"].max())],
                              triangles=[int(ref["num_valid_triangles"].min()),
                                         int(ref["num_valid_triangles"].max())])), flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        nums = control_numbers(cell, seed, device)
        print(json.dumps(dict(kind="control", seed=seed, numbers=nums)), flush=True)
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
        torch.cuda.empty_cache()
    fault_low = {}
    for name in args.faults:
        register = faults.FAULTS[name](harness.program()[0])
        for seed in args.fault_seeds:
            detail = {}
            res = harness.run(cell, seed, args.seconds, False, device, PROCESS_START,
                              register=register, detail=detail)
            nums = compare.gaps(detail["got"], detail["ref"])
            off = int((detail["got"]["best_score"] != detail["ref"]["best_score"]).sum())
            print(json.dumps(dict(kind="fault", fault=name, seed=seed, correct=res["correct"],
                                  failed=res["failed"], attempted=res["attempted"],
                                  numbers=nums, score_pairs_off=off,
                                  pairs=len(detail["got"]["best_score"]))), flush=True)
            low = fault_low.setdefault(name, {})
            for k, v in nums.items():
                low[k] = min(low.get(k, v), v)
            torch.cuda.empty_cache()
    print(json.dumps(dict(kind="summary", workload=args.workload, lower=lower, upper=upper,
                          faults=fault_low, numbers=list(compare.NUMBERS))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
