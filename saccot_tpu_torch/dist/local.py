"""Run a function on several ranks of one host, each in its own process.

    results = run_ranks(fn, 2, "gloo", *args)

spawns `world_size` processes with the `spawn` start method (the only one
that works once the parent has touched CUDA), points them at a free
localhost port (MASTER_ADDR / MASTER_PORT), joins each to the process group
(`dist.mesh.init_distributed(backend=backend)`), calls `fn(*args)` and
returns the ranks' results in rank order, with every tensor in them turned
into a NumPy array. `fn` must be importable by name (a module-level
function). With `explicit_init=True` the ranks join by `init_distributed`'s
explicit arguments (the address, world size and rank) instead, with the
rank variables removed from their environment.

A rank that raises fails the whole call with that rank's traceback; a rank
that dies without a result, or a call that outlives `timeout` seconds, fails
it too. Every process is stopped before the call returns or raises.

The parent builds the CUDA kernels first when a card is present; the ranks
then load the library from `build/`, where it is cached by source hash.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, List, Optional

import torch

# The env:// variables of a rank.
RANK_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(x: Any) -> Any:
    """Tensors (also inside tuples, named tuples, lists and dicts) as NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank: int, world_size: int, backend: Optional[str], port: int,
               explicit_init: bool, fn, args, results) -> None:
    import torch.distributed as dist

    from saccot_tpu_torch.dist.mesh import init_distributed

    try:
        if explicit_init:
            for name in RANK_VARS:
                os.environ.pop(name, None)
            init_distributed(f"127.0.0.1:{port}", world_size, rank, backend=backend)
        else:
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                              WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                              LOCAL_WORLD_SIZE=str(world_size))
            init_distributed(backend=backend)
        out = _to_host(fn(*args))
    except Exception:  # the rank's boundary: report the traceback to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: Optional[str], *args,
              timeout: float = 600.0, explicit_init: bool = False) -> List[Any]:
    """`fn(*args)` on `world_size` spawned ranks; their results in rank order.

    backend: "nccl", "gloo", or None for `init_distributed`'s choice.
    explicit_init: join by `init_distributed`'s arguments, not the
    environment.
    """
    if torch.cuda.is_available():
        from saccot_tpu_torch.kernels import _build

        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world_size, backend, port, explicit_init, fn, args,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world_size
    done = set()
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: ranks {sorted(set(range(world_size)) - done)} "
                                   f"gave no result within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        raise RuntimeError(f"run_ranks: rank {r} exited with code {p.exitcode} "
                                           "without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{payload}")
            out[rank] = payload
            done.add(rank)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"run_ranks: {p.name} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return out
