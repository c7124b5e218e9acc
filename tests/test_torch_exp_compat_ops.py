"""PyTorch port vs the JAX package: the timing variants of the degree kernel's
pair loop (`scripts/exp_compat_ops.py::variant_kernel` against
`saccot_tpu_torch/kernels/compat_ops.py`).

That script runs its whole N=50,000 experiment when it is imported, so the
test takes `variant_kernel`'s definition from the file's source with `ast`
and calls it through `pl.pallas_call(..., interpret=True)` with the
script's grid and BlockSpecs, on `_gram_features` of the same NumPy inputs
(uncentred, as the script builds them). N = 1,024 is a multiple of both
tiles (256 x 512), so no 1e15 pad column enters a JAX row sum. Kernel-vs-
plain checks need a card and skip here.
"""

import ast
import collections
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from saccot_tpu.kernels.compat import TILE_C, TILE_R, _gram_features
from saccot_tpu_torch.engine.compat import cross_sq_distances, pair_score
from saccot_tpu_torch.kernels import compat as kcompat
from saccot_tpu_torch.kernels.compat_ops import (
    FORMS, MODES, variant_degrees, variant_degrees_reference,
)
from saccot_tpu_torch.scripts import exp_compat_ops
from saccot_tpu_torch.utils.convert import KITTI_PARAMS, KITTI_SEED, kitti_problem_batch

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "exp_compat_ops.py"
# A string condition is evaluated when the test runs, not at import.
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device: the kernel has no CPU mode")
N = 1024
TAU, SEP = KITTI_PARAMS.compat_tau, KITTI_PARAMS.min_separation
# Squared distances from the split-bf16 Gram (|p_i|^2 + |p_j|^2 - 2 p_i.p_j,
# each norm and the Gram's 27 exact bf16 products summed in float32) and
# from direct differences differ by at most GRAM * (|p_i|^2 + |p_j|^2) per
# pair: about 32 roundings of 2^-24 over both sides (the worst pair of the
# test's input reads 2^-20.6).
GRAM = 2.0 ** -19
# Row sums in different orders (the JAX kernel's tile order, the port's
# column order): 1e-5 of the sum of the terms' magnitudes.
RTOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    """The script's problem cut to N: (P, Q) [1, N, 3] float32 on the CPU."""
    P, Q, _ = kitti_problem_batch([KITTI_SEED], device="cpu", n=N)
    return P, Q


def _variant_kernel():
    """The script's `variant_kernel`, defined from its source alone, with the
    module globals it reads (tau and min_sep of the kitti configuration)."""
    tree = ast.parse(SCRIPT.read_text(), filename=str(SCRIPT))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "variant_kernel")
    ns = dict(jax=jax, jnp=jnp, pl=pl, tau=TAU, min_sep=SEP)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns["variant_kernel"]


@pytest.fixture(scope="module")
def jax_rows(problem):
    """mode -> the JAX variant's row sums [N] (computed on first use)."""
    kernel = _variant_kernel()
    P, Q = (jnp.asarray(x[0].numpy()) for x in problem)
    rf, _, nr = _gram_features(P, Q, N)
    _, cf, nc = _gram_features(P, Q, N)
    cache = {}

    def rows(mode):
        if mode not in cache:
            # run_variant.fn's pallas_call (scripts/exp_compat_ops.py:93-105).
            out = pl.pallas_call(
                functools.partial(kernel, mode=mode),
                grid=(N // TILE_R, N // TILE_C),
                in_specs=[
                    pl.BlockSpec((64, TILE_R), lambda i, j: (0, i), memory_space=pltpu.VMEM),
                    pl.BlockSpec((2, TILE_R), lambda i, j: (0, i), memory_space=pltpu.VMEM),
                    pl.BlockSpec((64, TILE_C), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                    pl.BlockSpec((2, TILE_C), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                ],
                out_specs=pl.BlockSpec((1, TILE_R), lambda i, j: (0, i),
                                       memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((1, N), jnp.float32),
                interpret=True,
            )(rf, nr, cf, nc)
            cache[mode] = np.asarray(out)[0].astype(np.float64)
        return cache[mode]

    return rows


def _tolerance(P, Q, mode):
    """Per-row bound on |JAX - port| [N] and the number of pairs within the
    Gram's error of the min_sep threshold, from float64 pair quantities: the
    pair error each mode's formula carries from GRAM, summed over the row,
    where a pair that may flip the min_sep test counts its whole score (1),
    plus RTOL of the row's absolute sum."""
    X, Y = P[0].numpy().astype(np.float64), Q[0].numpy().astype(np.float64)
    a, b = (X ** 2).sum(1), (Y ** 2).sum(1)
    ep, eq = GRAM * (a[:, None] + a[None]), GRAM * (b[:, None] + b[None])
    dp2 = ((X[:, None] - X[None]) ** 2).sum(-1)
    dq2 = ((Y[:, None] - Y[None]) ** 2).sum(-1)
    near = np.zeros(dp2.shape, bool)
    if mode == "gram_only":
        v, err = X @ X.T + Y @ Y.T, ep + eq
    elif mode == "d2_only":
        v, err = dp2 + dq2, ep + eq
    else:
        dp, dq = np.sqrt(dp2), np.sqrt(dq2)
        # |sqrt(x) - sqrt(y)| <= min(sqrt|x - y|, |x - y| / sqrt(y))
        with np.errstate(divide="ignore"):
            erp = np.minimum(np.sqrt(ep), ep / dp)
            erq = np.minimum(np.sqrt(eq), eq / dq)
        if mode == "one_sqrt":
            v, err = dp + dq2, erp + eq
        elif mode == "no_sqrt_tail":
            delta = np.abs(dp2 - dq2)
            v = np.where(np.minimum(dp2, dq2) > SEP * SEP, np.maximum(1 - delta / TAU ** 2, 0), 0)
            near = np.abs(np.minimum(dp2, dq2) - SEP * SEP) <= np.maximum(ep, eq)
            live = delta < TAU ** 2 + ep + eq
            err = np.where(near, 1.0, np.minimum(1.0, (ep + eq) / TAU ** 2)) * live
        else:
            delta = np.abs(dp - dq)
            v = np.where(np.minimum(dp, dq) > SEP, np.maximum(1 - delta / TAU, 0), 0)
            near = np.abs(np.minimum(dp, dq) - SEP) <= np.maximum(erp, erq)
            live = delta < TAU + erp + erq
            err = np.where(near, 1.0, np.minimum(1.0, (erp + erq) / TAU)) * live
    return err.sum(1) + RTOL * np.abs(v).sum(1), int(near.sum())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", MODES)
def test_variant_matches_pallas_script(problem, jax_rows, mode, form):
    """Each mode of each form (the wrapper's plain version on CPU tensors)
    against the TPU script's kernel in interpret mode."""
    P, Q = problem
    got = variant_degrees(P, Q, KITTI_PARAMS, mode, form)[0].numpy().astype(np.float64)
    want = jax_rows(mode)
    tol, n_near = _tolerance(P, Q, mode)
    diff = np.abs(got - want)
    worst = int(np.argmax(diff - tol))
    assert np.all(diff <= tol), (
        f"{mode}/{form}: row {worst} differs by {diff[worst]:.4g} > {tol[worst]:.4g} "
        f"({n_near} pairs near min_sep)")
    # The bound says something: it is a small share of the rows' size, except
    # in no_sqrt_tail, where the Gram's error on |q|^2 up to 2e4 (0.02 read,
    # 0.08 bounded) is of the order of tau^2 = 0.09 and the bound counts the
    # live pairs; there `test_bound_rejects_a_planted_mistake` shows that it
    # still tells a wrong formula from the right one.
    if mode != "no_sqrt_tail":
        assert tol.sum() <= 0.05 * np.abs(want).sum(), (mode, form)


# mode -> a plain formula with one planted mistake, from the pair's squared
# distances [1, N, N] (and P, Q for gram_only).
MISTAKES = {
    ("gram_only", "q_dot_dropped"): lambda P, Q, dp2, dq2: P @ P.transpose(-1, -2),
    ("d2_only", "dq2_dropped"): lambda P, Q, dp2, dq2: dp2,
    ("one_sqrt", "root_of_dq2"): lambda P, Q, dp2, dq2: dp2 + torch.sqrt(dq2),
    ("no_sqrt_tail", "min_sep_test_dropped"): lambda P, Q, dp2, dq2: torch.clamp_min(
        1.0 - torch.abs(dp2 - dq2) / TAU ** 2, 0.0),
    ("no_sqrt_tail", "tau_for_tau2"): lambda P, Q, dp2, dq2: torch.where(
        torch.minimum(dp2, dq2) > SEP ** 2,
        torch.clamp_min(1.0 - torch.abs(dp2 - dq2) / TAU, 0.0), 0.0),
    ("full", "min_sep_test_dropped"): lambda P, Q, dp2, dq2: torch.clamp_min(
        1.0 - torch.abs(torch.sqrt(dp2) - torch.sqrt(dq2)) / TAU, 0.0),
    ("full", "tau2_for_tau"): lambda P, Q, dp2, dq2: pair_score(
        torch.sqrt(dp2), torch.sqrt(dq2), TAU ** 2, SEP),
}


@pytest.mark.parametrize("mode,mistake", list(MISTAKES))
def test_bound_rejects_a_planted_mistake(problem, jax_rows, mode, mistake):
    """The per-row bound of `test_variant_matches_pallas_script` has power: a
    plain version with one planted mistake (a dropped term or test, tau in
    place of tau^2) falls outside it on some row."""
    P, Q = problem
    dp2, dq2 = cross_sq_distances(P, P), cross_sq_distances(Q, Q)
    wrong = MISTAKES[mode, mistake](P, Q, dp2, dq2).sum(-1)[0].numpy().astype(np.float64)
    tol, _ = _tolerance(P, Q, mode)
    assert np.any(np.abs(wrong - jax_rows(mode)) > tol), (mode, mistake)


@pytest.mark.parametrize("mode", MODES)
def test_tri_decomposition_equals_row_sums(problem, mode):
    """The tri form's upper-triangle tile pairs (two 512-point tiles, rows
    and columns summed per tile, tiles in order) give the two-sided row sums
    over the same pairs, on a batch of two problems."""
    P1, Q1 = problem
    P2, Q2, _ = kitti_problem_batch([KITTI_SEED + 1], device="cpu", n=N)
    P, Q = torch.cat([P1, P2]), torch.cat([Q1, Q2])
    two = variant_degrees(P, Q, KITTI_PARAMS, mode, "two_sided")
    tri = variant_degrees(P, Q, KITTI_PARAMS, mode, "tri")
    if mode in ("no_sqrt_tail", "full"):
        torch.testing.assert_close(tri, two, rtol=1e-5, atol=1e-4)
    else:
        # RTOL of the rows' absolute sums; gram_only's terms take both signs,
        # so its sums of |p_i||p_j| + |q_i||q_j| bound them.
        scale = (variant_degrees(P.abs(), Q.abs(), KITTI_PARAMS, mode, "two_sided")
                 if mode == "gram_only" else two)
        assert torch.all((tri - two).abs() <= RTOL * scale)
    if mode == "full":
        # full is the degree: the production plain degrees on unmasked input.
        torch.testing.assert_close(two, kcompat.degrees_reference(P, Q, P, Q, KITTI_PARAMS),
                                   rtol=1e-5, atol=1e-4)


def test_attribution_script_runs_on_the_cpu(capsys):
    """`python -m saccot_tpu_torch.scripts.exp_compat_ops --device cpu` at a
    small N: every form and mode, d2_only as the zero of its form."""
    rows = exp_compat_ops.main(["1", "--n", "300", "--device", "cpu"])
    assert [(r["form"], r["mode"]) for r in rows] == [(f, m) for f in FORMS for m in MODES]
    for r in rows:
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["bound_by"] == "operations"
        if r["mode"] == "d2_only":
            assert r["over_d2_ms"] == 0.0
    out = capsys.readouterr().out
    assert "no device time" in out and "no_sqrt_tail" in out


@needs_cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", MODES)
def test_variant_kernel_matches_plain_on_card(mode, form):
    """Kernel against its plain version at N=3,000: modes without a threshold
    rtol 1e-5 (row sums in different orders), threshold modes rtol 1e-5 /
    atol 2e-3 as the degree rows; full bit for bit against the production
    kernel of its form."""
    P, Q, _ = kitti_problem_batch([KITTI_SEED], device="cuda", n=3000)
    got = variant_degrees(P, Q, KITTI_PARAMS, mode, form)
    ref = variant_degrees_reference(P, Q, KITTI_PARAMS, mode, form)
    atol = 2e-3 if mode in ("no_sqrt_tail", "full") else 0.0
    if mode == "gram_only":
        atol = 1e-5 * variant_degrees_reference(P.abs(), Q.abs(), KITTI_PARAMS, mode,
                                                "two_sided").max().item()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=atol)
    if mode == "full":
        prod = (kcompat.degrees_tri(P, Q, KITTI_PARAMS) if form == "tri" else
                kcompat.degrees_two_sided(P, Q, P, Q, KITTI_PARAMS))
        assert torch.equal(got, prod)


def test_sass_listing_is_parsed_per_variant():
    """The SASS report keys each variant kernel by form and mode (and a
    two-sided instance by its rows a thread), counts its opcodes (NOPs
    aside) and the body of its longest backward branch."""
    head = "\t\tFunction : _ZN46_GLOBAL__N__0e118eed_13_compat_ops_cu_c83ea518"
    listing = "\n".join([
        head + "18tri_degrees_kernelILb0ENS_7VariantILi2EEEEEvPKfS4_S4_PfiiT0_",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "        /*0010*/                   MUFU.RSQ R15, R20 ;",
        "        /*0020*/              @!P0 BRA 0x40 ;",
        "        /*0030*/                   NOP ;",
        "        /*0040*/                   FADD R1, R2, R3 ;",
        "        /*0050*/               @P6 BRA 0x10 ;",
        "        /*0060*/                   EXIT ;",
        "\t\tFunction : _ZN54_GLOBAL__N__16b109ba_21_compat_degrees_tri_cu_1331fec5"
        "18tri_degrees_kernelILb1EN6saccot11CompatScoreEEEvPKfS4_S4_PfiiT0_",
        "        /*0000*/                   FADD R1, R2, R3 ;",
        head + "24two_sided_degrees_kernelILi4ELb0ENS_10PointsViewES1_NS_7VariantILi4EEENS_9"
        "StoreSumsEEEvT1_T2_iixxPfPiT3_T4_",
        "        /*0000*/                   EXIT ;",
        head + "24two_sided_degrees_kernelILi2ELb0ENS_10PointsViewES1_NS_7VariantILi1EEENS_9"
        "StoreSumsEEEvT1_T2_iixxPfPiT3_T4_",
        "        /*0000*/                   FADD R1, R2, R3 ;",
        "\t\tFunction : _ZN54_GLOBAL__N__16b109ba_21_compat_degrees_cu_1331fec5"
        "24two_sided_degrees_kernelILi4ELb1ENS_10PointsViewES1_N6saccot11CompatScoreENS_9"
        "StoreSumsEEEvT1_T2_iixxPfPiT3_T4_",
        "        /*0000*/                   FADD R1, R2, R3 ;",
    ])
    got = exp_compat_ops.parse_sass(listing)
    assert sorted(got) == ["tri/one_sqrt", "two_sided/d2_only/rows2", "two_sided/full/rows4"]
    tri = got["tri/one_sqrt"]
    assert tri["ops"] == {"LDC": 1, "MUFU.RSQ": 1, "BRA": 2, "FADD": 1, "EXIT": 1}
    assert tri["loop"] == 4 and got["two_sided/full/rows4"]["loop"] == 0
    assert got["two_sided/d2_only/rows2"]["ops"] == {"FADD": 1}


def test_sass_report_gives_each_instance_its_root_cost(capsys):
    """print_sass pairs each instance's one_sqrt with its own d2_only: a
    two-sided instance of 2 rows a thread with the d2_only of 2 rows."""
    def kernel(n, rsq):
        ops = collections.Counter({"FADD": n - rsq, "MUFU.RSQ": rsq})
        return dict(ops=ops, loop=8)
    exp_compat_ops.print_sass({
        "two_sided/one_sqrt/rows2": kernel(130, 4), "two_sided/d2_only/rows2": kernel(90, 0),
        "two_sided/one_sqrt/rows1": kernel(70, 2), "two_sided/d2_only/rows1": kernel(50, 0),
        "tri/one_sqrt": kernel(96, 32), "tri/d2_only": kernel(64, 0)})
    out = capsys.readouterr().out
    assert "two_sided/rows2: one_sqrt - d2_only = 10.00 instructions per root" in out
    assert "two_sided/rows1: one_sqrt - d2_only = 10.00 instructions per root" in out
    assert "tri: one_sqrt - d2_only = 1.00 instructions per root" in out
    assert "hot loop 8 = 0.2 per pair" in out


def test_modes_are_the_scripts():
    """The port keeps the script's five mode names, in its order."""
    src = SCRIPT.read_text()
    order = [src.index(f'"{m}"', src.index("for mode in")) for m in MODES]
    assert order == sorted(order)
