"""The symmetric degree kernel on the benchmark cells' batches: its time a
call, the share of tile pairs it skipped, and its degrees for a bit-for-bit
comparison with another checkout's.

    python -m saccot_tpu_torch.scripts.exp_tri_skip [--seed S] [--save DIR] [--compare DIR]

Makes the distinct batches of `kitti.masked`, `threedlomatch.sweep` and
`kitti.sweep` from `--seed` with `regbench/generate.py`, and, as a layout
that leaves no tile empty, `kitti.sweep`'s batches with every 7th
correspondence masked (`kitti.every_7th`). On each batch it runs
`kernels/compat.degrees_tri` as `register_batch` does (float32 points, the
mask as float32) and prints one JSON line a case: the call's ms (CUDA
events, median of 5 after a warm call), the share of the batch's tile pairs
the kernel skipped (from `compat.TILE_PAIRS_SKIPPED`; null where the package
keeps no count or the call has no mask) and whether two calls gave the same
bits. --save writes each batch's degrees under DIR; --compare checks each
against DIR's bit for bit. Needs a CUDA device.

To hold two checkouts to each other on one card, run this file inside the
other checkout, with that checkout first on the path, then here:

    cd OTHER && PYTHONPATH=. python THIS/saccot_tpu_torch/scripts/exp_tri_skip.py --save D/other
    python -m saccot_tpu_torch.scripts.exp_tri_skip --compare D/other
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from regbench import generate
from saccot_tpu_torch.kernels import compat
from saccot_tpu_torch.scripts.exp_compat_ops import time_ms
from saccot_tpu_torch.utils.params import SacCotParams

SEED = 2718281828459
CELLS = (("kitti.masked", "kitti", "batch64_nvalid"),
         ("threedlomatch.sweep", "threedlomatch", "split1781_nvalid"),
         ("kitti.sweep", "kitti", "batch64"))


def cases(seed: int, dev: torch.device):
    """(case, params, batches): each batch (P, Q, mask or None)."""
    root = Path(generate.__file__).resolve().parent
    for cell, config, traffic in CELLS:
        cfg = json.loads((root / "configs" / f"{config}.json").read_text())
        mix = json.loads((root / "traffic" / f"{traffic}.json").read_text())
        batches = [(P.float(), Q.float(), None if mask is None else mask.float())
                   for P, Q, _, mask in generate.cell_batches(seed, cfg, mix, device=dev)]
        params = SacCotParams(**cfg["params"])
        yield cell, params, batches
        if cell == "kitti.sweep":
            scattered = []
            for P, Q, _ in batches:
                mask = torch.ones(P.shape[:2], device=dev)
                mask[:, ::7] = 0
                scattered.append((P, Q, mask))
            yield "kitti.every_7th", params, scattered


def skipped_share(n: int, batch: int):
    """The last masked launch's skipped tile pairs over the batch's tile
    pairs, or None where the package keeps no count."""
    store = getattr(compat, "TILE_PAIRS_SKIPPED", None)
    if not store:
        return None
    tiles = -(-n // 128)
    return store[-1].sum().item() / (batch * tiles * (tiles + 1) // 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--save", type=Path)
    ap.add_argument("--compare", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_tri_skip times the card's kernel: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(dev), flush=True)
    if args.save:
        args.save.mkdir(parents=True, exist_ok=True)
    same_as_other = True
    for case, params, batches in cases(args.seed, dev):
        out = dict(case=case, ms=[], skipped_share=[], two_calls_same=[], same_as_other=[])
        for i, (P, Q, mask) in enumerate(batches):
            store = getattr(compat, "TILE_PAIRS_SKIPPED", None)
            if store is not None:
                store.clear()
            deg = compat.degrees_tri(P, Q, params, mask=mask)
            out["skipped_share"].append(skipped_share(P.shape[1], P.shape[0]))
            out["two_calls_same"].append(torch.equal(deg, compat.degrees_tri(P, Q, params,
                                                                              mask=mask)))
            out["ms"].append(time_ms(lambda: compat.degrees_tri(P, Q, params, mask=mask),
                                     reps=5, warmup=1))
            name = f"{case}.{i}.pt"
            if args.save:
                torch.save(deg.cpu(), args.save / name)
            if args.compare:
                same = torch.equal(deg.cpu(), torch.load(args.compare / name))
                out["same_as_other"].append(same)
                same_as_other &= same
        print(json.dumps(out), flush=True)
    if args.compare:
        print(f"degrees bit for bit those under {args.compare}: {same_as_other}", flush=True)
    return 0 if same_as_other else 1


if __name__ == "__main__":
    raise SystemExit(main())
