"""The port's public surface holds the JAX package's, function by function.

Both packages are read by `ast`; nothing is imported. For every public
top-level `def` and `class` of every `saccot_tpu/**/*.py`, the file of the
same path in `saccot_tpu_torch/` defines the same name, or `EXEMPT` names its
counterpart and the reason. For every argument of such a function, the
port's function takes the argument, or its `RENAMED` spelling, or `EXEMPT`
gives the reason it has none.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "saccot_tpu"
PORT = REPO / "saccot_tpu_torch"

# Reference spelling -> the port's. A JAX mesh axis is named by a string;
# the port passes the torch.distributed group of that axis.
RENAMED = {
    "axis_name": "group",
    "corr_axis": "corr_group",
    "hyp_axis": "hyp_group",
    "anchor_axis": "anchor_group",
    "P_shard": "P_loc",
    "Q_shard": "Q_loc",
    "mask_shard": "mask_loc",
    # The SLAM dry runs take the group of the mesh's "corr" axis.
    "mesh": "group",
}

_PALLAS = "a Pallas wrapper; its SoA form is a TPU layout, the port's wrapper takes one layout"
# "module:name" or "module:name(argument)" -> ("port counterpart", "reason").
EXEMPT = {
    "kernels/compat.py:degrees_pallas": ("kernels/compat.py:degrees", _PALLAS),
    "kernels/ring_compat.py:degrees_ring_pallas": ("kernels/ring_compat.py:ring_degrees_step",
                                                   _PALLAS),
    "kernels/score.py:score_hypotheses_pallas": ("kernels/score.py:score_hypotheses", _PALLAS),
    "kernels/score.py:score_hypotheses_pallas_soa": ("kernels/score.py:score_hypotheses",
                                                     _PALLAS),
    "kernels/solve3.py:solve3_pallas": ("kernels/solve3.py:solve3", _PALLAS),
    "kernels/solve3.py:solve3_pallas_soa": ("kernels/solve3.py:solve3", _PALLAS),
    "kernels/triangles.py:anchor_neighbors_pallas": ("kernels/triangles.py:anchor_neighbors",
                                                     _PALLAS),
    "kernels/triangles.py:anchor_neighbors_stream_pallas": (
        "kernels/triangles.py:anchor_neighbors_stream", _PALLAS),
    "kernels/triangles.py:candidate_topt_pallas": ("kernels/triangles.py:candidate_topt",
                                                   _PALLAS),
    "dist/mesh.py:pair_sharding": (
        "dist/sweep.py:make_sweep_fn",
        "a JAX NamedSharding; the sweep slices each rank's block of the batch itself"),
    "dist/mesh.py:replicated": (
        "dist/sweep.py:make_sweep_fn",
        "a JAX NamedSharding; a torch tensor that every rank holds is replicated"),
    "dist/mesh.py:make_mesh(devices)": (
        "dist/mesh.py:make_mesh",
        "a torch world is the launch's ranks; a subset of them is a smaller launch"),
    "features/eig3.py:smallest_eigvec3_sym(evals)": (
        "features/eig3.py:smallest_eigvec3_sym",
        "the reference never reads it (saccot_tpu/features/eig3.py:137)"),
    "evaluation/roofline.py:compat_degrees_model(mxu)": (
        "evaluation/roofline.py:compat_degrees_model",
        "the port's roofline is the Hopper model: one model a kernel row, not a TPU unit"),
    "evaluation/roofline.py:compat_degrees_model(symmetric)": (
        "evaluation/roofline.py:compat_degrees_model",
        "the port's roofline is the Hopper model: one model a kernel row, not a TPU unit"),
    "evaluation/roofline.py:stage_bound_seconds(highest)": (
        "evaluation/roofline.py:stage_bound_seconds",
        "the port's roofline is the Hopper model: FP32 has one rate, no MXU precision"),
}


def _surface(path: Path):
    """Public top-level names of a file: a function's argument names, or
    None for a class."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, ast.FunctionDef):
            a = node.args
            out[node.name] = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                              + [a.vararg, a.kwarg] if x is not None]
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
    return out


def _all_surfaces(root: Path):
    return {p.relative_to(root).as_posix(): _surface(p) for p in sorted(root.rglob("*.py"))}


REF_SURFACE = _all_surfaces(REF)
PORT_SURFACE = _all_surfaces(PORT)


def _missing(module: str):
    """Every reference name and argument of `module` the port lacks and
    `EXEMPT` does not excuse."""
    port = PORT_SURFACE.get(module, {})
    bad = []
    for name, args in REF_SURFACE[module].items():
        key = f"{module}:{name}"
        if key in EXEMPT:
            continue
        if name not in port or (args is None) != (port[name] is None):
            bad.append(key)
            continue
        for arg in args or ():
            if arg in port[name] or RENAMED.get(arg) in port[name]:
                continue
            if f"{key}({arg})" not in EXEMPT:
                bad.append(f"{key}({arg})")
    return bad


@pytest.mark.parametrize("module", sorted(REF_SURFACE))
def test_every_public_name_and_argument_has_a_counterpart(module):
    assert (PORT / module).is_file(), f"saccot_tpu_torch/{module} is missing"
    missing = _missing(module)
    assert not missing, missing


def test_exemptions_name_reference_entries_and_existing_counterparts():
    """Every `EXEMPT` entry is a name or argument of the reference that the
    port lacks, and its counterpart is a public name of the port."""
    for key, (counterpart, reason) in EXEMPT.items():
        module, name = key.split(":")
        name, _, arg = name.partition("(")
        ref = REF_SURFACE[module]
        assert name in ref, key
        if arg:
            arg = arg.rstrip(")")
            assert arg in ref[name] and arg not in PORT_SURFACE[module][name], key
        else:
            assert name not in PORT_SURFACE.get(module, {}), key
        c_module, c_name = counterpart.split(":")
        assert c_name in PORT_SURFACE[c_module], counterpart
        assert reason


def test_every_rename_is_used_and_its_target_taken():
    """Each `RENAMED` spelling is an argument of some reference function whose
    port counterpart takes the target instead."""
    used = set()
    for module, names in REF_SURFACE.items():
        for name, args in names.items():
            port = PORT_SURFACE.get(module, {}).get(name)
            used |= {arg for arg in args or ()
                     if port and arg not in port and RENAMED.get(arg) in port}
    assert used == set(RENAMED)

