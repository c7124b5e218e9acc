"""On the card: the command runs each cell end to end (a short window, then
a traced one) and its last lines are the result and the compared numbers.
Without a card the command must refuse, printing no result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seed, trace):
    return subprocess.run([sys.executable, "-m", "regbench.run", "--workload", cell,
                           "--seed", str(seed), "--seconds", "2", "--trace", str(trace)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)


def test_without_a_card_the_command_refuses():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(CELLS[0], 1, 0)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(cell, 2 ** 31 + 101 + trace, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] > 0, res
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "compared"
    tail = out.stderr.strip().splitlines()[-len(res["compared"]):]
    assert [line.split()[1] for line in tail] == list(res["compared"])
    if trace:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
        assert all(v["value"] <= 105.0 for k, v in res["metrics"].items()
                   if k.endswith("_roofline"))
