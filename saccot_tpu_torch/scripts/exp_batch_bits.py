"""Which fields of a registration depend on the batch it runs in.

    python -m saccot_tpu_torch.scripts.exp_batch_bits [--device cpu]

At the bench point (128 pairs, seeds 1000+s, N=1,000, fast configuration)
and the 3DMatch point (32 pairs, seeds 300+s, N=2,048, exact
configuration) it registers the whole batch, then pairs 5 and 7 alone
(`register_pair`), and prints for each field whether it has the batch
row's bits and the largest difference; then, for batches of the first 1, 2,
16 and 64 pairs, on how many rows T has the whole batch's bits. Every
kernel, the refine's (`csrc/refine.cu`) included, sums in an order fixed
by N alone, so on the card every field is expected to keep its bits; on
the CPU the plain refine's torch sums (`engine/svd3.umeyama`) may not, so
R, t and T may move by rounding there. Runs on the card unless given
--device cpu.
"""

from __future__ import annotations

import argparse

import torch

from saccot_tpu_torch import register_batch, register_pair
from saccot_tpu_torch.utils.convert import problem_batch
from saccot_tpu_torch.utils.params import SacCotParams

FAST = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03, num_anchors=256,
                    neighbors_per_anchor=12, max_hypotheses=1024, dedup_triangles=False,
                    approx_topk=True, per_anchor_candidates=4)
TDM = SacCotParams(compat_tau=0.05, min_separation=0.1, inlier_tau=0.05, num_anchors=256,
                   neighbors_per_anchor=16, max_hypotheses=2048)
POINTS = (("bench", FAST, range(1000, 1128), 1000, 0.8, 0.004),
          ("3dmatch", TDM, range(300, 332), 2048, 0.9, 0.01))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(dev), flush=True)
    for name, params, seeds, n, outliers, noise in POINTS:
        P, Q, _ = problem_batch(seeds, device=dev, n=n, outlier_ratio=outliers, noise=noise)
        whole = register_batch(P, Q, params)
        for b in (5, 7):
            one = register_pair(P[b], Q[b], params)
            fields = ", ".join(
                f"{f} {'same' if torch.equal(x, y[b]) else 'differs'} "
                f"{(x.double() - y[b].double()).abs().max().item():.3g}"
                for f, x, y in zip(whole._fields, one, whole))
            print(f"{name} pair {b} alone: {fields}", flush=True)
        for size in (1, 2, 16, 64):
            if size > P.shape[0]:
                continue
            part = register_batch(P[:size], Q[:size], params)
            same = int((part.T == whole.T[:size]).flatten(1).all(dim=1).sum())
            print(f"{name} batch of {size}: T the whole batch's bits on {same} of {size} rows",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
