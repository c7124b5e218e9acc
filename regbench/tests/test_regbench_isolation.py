"""The benchmark loads neither JAX nor the JAX package, and its reference
takes nothing from the program. Top-level module names are compared whole:
the port's name, `saccot_tpu_torch`, begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "saccot_tpu"}


def _imports(path: Path):
    """Every module an import statement of the file names; relative imports
    as written (level > 0)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def _sources():
    return sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    bad = [f"{p.relative_to(REPO)}: {m}" for p in _sources() for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_top_level_names_are_compared_whole():
    from regbench.run import forbidden_modules

    assert "saccot_tpu_torch".split(".")[0] not in FORBIDDEN
    before = set(sys.modules)
    sys.modules["saccot_tpu_torch_probe"] = sys.modules[__name__]
    try:
        assert forbidden_modules() == sorted({m.split(".")[0] for m in before} & FORBIDDEN)
    finally:
        del sys.modules["saccot_tpu_torch_probe"]


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((ROOT / "reference").rglob("*.py")):
        for m in _imports(p):
            assert m.split(".")[0] in {"__future__", "typing", "numpy", "torch"}, (p, m)


def test_the_harness_reads_no_generator_or_yardstick_of_the_program():
    # From the program the benchmark takes only the estimator entry and its
    # parameter type.
    allowed = {"saccot_tpu_torch.engine.sac_cot", "saccot_tpu_torch.utils.params"}
    for p in _sources():
        for m in _imports(p):
            if m.split(".")[0] == "saccot_tpu_torch":
                assert m in allowed, (p, m)


def test_a_run_loads_no_jax(tmp_path):
    # A whole tiny run in a fresh process, then its modules.
    code = (
        "import sys, torch, dataclasses\n"
        "from regbench import harness\n"
        "from regbench.tests.tiny import tiny_cell\n"
        "cell = tiny_cell('threedmatch.sweep')\n"
        "res = harness.run(cell, 5, 0.2, True, torch.device('cpu'), 0.0)\n"
        "from regbench.run import forbidden_modules\n"
        "print(res['correct'], forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
