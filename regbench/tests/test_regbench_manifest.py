"""BENCHMARK.json and every file under regbench/ keep to the benchmark's
contract: keys, names, units, limits, and a file for each name."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = {w["name"] for w in MANIFEST["workloads"]}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def _reports(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w.split("/") for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()
    assert cmd[:3] == ["python3", "-m", "regbench.run"]


def test_run_seconds_fit_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    configs = MANIFEST["configs"]
    assert 1 <= len(configs) <= 24
    files = [c["file"] for c in configs]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used
        for key in ("n", "problem", "params", "criterion", "precision"):
            assert key in body, (c["name"], key)


def test_workloads():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert len(CELLS) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
        assert {"pairs_per_call", "calls_in_flight", "distinct_batches",
                "trace_calls"} <= set(traffic)
        spec = json.loads((ROOT / "workloads" / f"{w['name']}.json").read_text())
        assert {"sample_pairs", "reference_block", "limits"} <= set(spec)


def _metric_common(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "workloads" in m:
        assert m["workloads"] and set(m["workloads"]) <= CELLS
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_end_to_end_metrics():
    e2e = MANIFEST["end_to_end"]
    assert 1 <= len(e2e) <= 16
    names = [m["name"] for m in e2e]
    assert "setup_s" in names
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        _metric_common(m)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "e2e" / f"{m['name']}.py").is_file()
    for cell in CELLS:
        reported = [m["name"] for m in e2e if _reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2, cell


def test_per_layer_metrics():
    per_layer = MANIFEST["per_layer"]
    assert 1 <= len(per_layer) <= 128
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in per_layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        _metric_common(m)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in CELLS:
        assert any(_reports(m, cell) for m in per_layer), cell


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_file_parses_and_is_named_from_name_characters():
    files = [p for p in ROOT.rglob("*") if p.is_file() and "__pycache__" not in p.parts]
    assert files
    for p in files:
        rel = p.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        if p.suffix == ".json":
            json.loads(p.read_text())
        elif p.suffix == ".py":
            ast.parse(p.read_text(), filename=rel)
        else:
            pytest.fail(f"unexpected file {rel}")


def test_every_reader_has_read():
    for kind in ("e2e", "metrics"):
        for p in sorted((ROOT / kind).glob("*.py")):
            tree = ast.parse(p.read_text())
            assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body), p
