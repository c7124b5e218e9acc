"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison, and the result line.

Everything specific to a cell lives in files the harness finds by name:
`BENCHMARK.json` at the repository root names the cell's configuration,
traffic and metrics; `configs/<config>.json` holds the configuration's sizes
and parameters, `traffic/<traffic>.json` the mix the generator reads,
`workloads/<cell>.json` the sample and limits of the comparison, and each
metric is read by its own module, `e2e/<name>.py` or `metrics/<name>.py`,
whose `read(ctx)` returns a number or None (nothing to read).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from regbench import compare, generate, loop, trace
from regbench.reference import saccot as reference

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    spec: Dict                # workloads/<cell>.json: sample and limits
    end_to_end: List[Dict]    # the manifest's entries this cell reports
    per_layer: List[Dict]


def _reports(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, manifest_path: Path = REPO / "BENCHMARK.json") -> Cell:
    """The cell `name` of the manifest, with its files."""
    manifest = load_json(manifest_path)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(manifest_path.parent / cfg_entry["file"]),
        traffic=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
        spec=load_json(ROOT / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def load_reader(kind: str, name: str):
    """The module of a metric: `e2e/<name>.py` or `metrics/<name>.py`."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"regbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a metric's reader sees of a run."""
    batch: int
    n: int
    params: Dict
    setup_s: float
    window: loop.Window
    timeline: Optional[trace.Timeline] = None


def program():
    """The system under test: the estimator entry on its kernel route, and
    its parameter type."""
    from saccot_tpu_torch.engine.sac_cot import register_batch
    from saccot_tpu_torch.utils.params import SacCotParams
    return functools.partial(register_batch, impl="kernel"), SacCotParams


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        process_start: float, register: Optional[Callable] = None,
        clock=time.perf_counter, detail: Optional[Dict] = None) -> Dict:
    """One run; returns the result dict (`correct`, `attempted`, `failed`,
    `metrics`, `device`, `breakdown` when traced, `compared` last).
    `register`: the estimator (default: the program's `register_batch` with
    impl="kernel"), called as register(P, Q, params, mask=...). `detail`: a dict
    that gets the window, the set-up's steps (seconds from the process
    start at the end of each) and the reference's outputs."""
    detail = {} if detail is None else detail
    steps = detail["setup_steps"] = {"start": clock() - process_start}
    entry, params_type = program()
    steps["import"] = clock() - process_start
    register = entry if register is None else register
    cfg, traffic, spec = cell.config, cell.traffic, cell.spec
    prm = cfg["params"]
    params = params_type(**prm)
    batch, in_flight = int(traffic["pairs_per_call"]), int(traffic["calls_in_flight"])

    batches = generate.cell_batches(seed, cfg, traffic, device=device)
    T_host = [b[2].cpu().numpy() for b in batches]
    steps["data"] = clock() - process_start

    def call(i: int) -> Dict[str, torch.Tensor]:
        P, Q, _, mask = batches[i % len(batches)]
        with torch.profiler.record_function(trace.CALL_RANGE):
            res = register(P, Q, params, mask=mask)
        return {f: getattr(res, f) for f in compare.FIELDS}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    slots: list = []
    warm = int(traffic.get("warm_calls", in_flight + 1))
    loop.run_calls(call, compare.FIELDS, in_flight, batch, count=warm, slots=slots, clock=clock)
    sync()
    setup_s = steps["warm_up"] = clock() - process_start

    gc.collect()
    window = loop.run_calls(call, compare.FIELDS, in_flight, batch, seconds=seconds,
                            first_index=warm, slots=slots, clock=clock)
    timeline = None
    if traced:
        sync()
        with trace.capture() as prof:
            loop.run_calls(call, compare.FIELDS, in_flight, batch,
                           count=int(traffic["trace_calls"]), slots=slots, clock=clock)
        timeline = trace.timeline(prof)
        del prof
    memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)

    ctx = Context(batch=batch, n=int(cfg["n"]), params=prm, setup_s=setup_s,
                  window=window, timeline=timeline)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_reader("metrics" if traced else "e2e", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The comparison: the sampled pairs' inputs kept, the program's freed.
    sample = compare.draw_sample(seed, len(window.calls), batch, int(spec["sample_pairs"]))
    got = {f: np.stack([window.calls[c].out[f][p] for c, p in sample]) for f in compare.FIELDS}

    def pick(k):
        if batches[0][k] is None:
            return None
        return torch.stack([batches[window.calls[c].index % len(batches)][k][p]
                            for c, p in sample]).clone()

    P_s, Q_s, mask_s = pick(0), pick(1), pick(3)
    failed = compare.failed_pairs(window.calls, T_host, cfg["criterion"])
    attempted = window.pairs
    del batches, call, slots
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_ref = clock()
    try:
        ref = compare.run_reference(reference.register, P_s, Q_s, mask_s, prm,
                                    int(spec["reference_block"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    numbers = compare.gaps(got, ref)
    detail.update(window=window, got=got, ref=ref, reference_s=clock() - t_ref)
    limits = spec["limits"]

    result = {
        "correct": bool(attempted > 0 and compare.judge(numbers, limits)),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device(device, cell.chips, memory_peak, timeline),
    }
    if timeline is not None:
        result["breakdown"] = {"device_ops": timeline.top_ops(10),
                               "idle_gaps": timeline.top_gaps(10)}
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in compare.compared(limits)}
    return result


def _device(device: torch.device, chips: int, memory_peak: int,
            timeline: Optional[trace.Timeline]) -> Dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
               "memory_peak_bytes": int(memory_peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if timeline is not None:
        out["busy_s"] = timeline.busy_s
        out["window_s"] = timeline.window_s
    return out
