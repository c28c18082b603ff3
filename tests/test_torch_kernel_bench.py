"""mpmvs_torch.tools.kernel_bench on the CPU: its field builders against
the JAX tool's construction (tools/kernel_bench.py:86-108, through
mpmvs_tpu.ops.random) from the same key, its capture of a real band
step's NCC calls, the sorted-path and bilateral cases it builds, its
count of instructions a tap (the bilateral kernel) and an entry (the
geometric-cost kernel) from a SASS listing, the geometric-cost cases it
builds, and its refusal to run without a CUDA device, for every
kernel.

Tolerance: as test_torch_random.py's derived fields (trig and
normalisation on the draws, each op within an ulp or two): planes within
rtol 1e-5 and atol 1e-5; a depth taken back from a plane built on it
within rtol 1e-4."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import geometry as jgeo
from mpmvs_tpu.ops import random as jr
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_torch import geometry as geo
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.tools import kernel_bench

from torch_parity import n, t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_fields(case, key, k, K, xb, yb, dmin, dmax, params):
    """The JAX tool's stack_planes and its cases, at a small size."""
    if case == "full":
        return jnp.stack([jr.random_plane_field(kk, K, xb, yb, dmin, dmax)
                          for kk in jax.random.split(key, k)])
    cone = math.radians(params.init_normal_cone_deg)
    normal_fn = {
        "coherent": lambda kn: jr.cone_normal_field(kn, K, xb, yb, cone),
        "trials": lambda kn: jr.random_normal_field(kn, K, xb, yb)}[case]
    ks = jax.random.split(key, k)
    fields = []
    for i in range(k):
        kn, kd = jax.random.split(ks[i])
        d = jr.smooth_banded_uniform(*jax.random.split(kd), xb, yb, dmin,
                                     dmax, params.random_band_frac)
        fields.append(jgeo.plane_from_depth_normal(K, xb, yb, d,
                                                   normal_fn(kn)))
    return jnp.stack(fields)


@pytest.mark.parametrize("case", ["coherent", "trials", "full"])
def test_fields_match_jax_tool(case):
    K = np.array([[300.0, 0, 150.0], [0, 290.0, 40.0], [0, 0, 1]],
                 np.float32)
    xb, yb = jgeo.pixel_grid(24, 300)
    yb = yb + 16.0
    dmin, dmax = np.float32(1.5), np.float32(12.0)
    want = _jax_fields(case, jax.random.PRNGKey(7), 3, jnp.asarray(K), xb,
                       yb, dmin, dmax, JaxParams())
    got = kernel_bench.FIELDS[case](
        tf.PRNGKey(7), 3, t(K), t(xb), t(yb), torch.tensor(dmin),
        torch.tensor(dmax), PatchMatchParams())
    assert got.shape == (3, 24, 300, 4)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("semantics", ["default", "reference"])
def test_step_calls_are_the_band_step_calls(semantics):
    """One half-iteration from the true planes makes the K=9 candidate
    call and the K=5 trial call, the latter through the view-major launch
    only with full-range draws; trials 1 and 3 keep the converged depth,
    trials 0 and 2 draw theirs: in a band under the default semantics,
    over the whole depth range under the reference's."""
    bench = kernel_bench.setup(48, 64, 4, 0, device="cpu")
    calls = kernel_bench.step_calls(bench, semantics)
    assert [args[7].shape[0] for args, _ in calls] == [9, 5]
    # the launch the solver picks: view-major only for full-range trials
    assert [kw["scattered"] for _, kw in calls] == [
        False, semantics == "reference"]
    args, _ = calls[1]
    data, x, y = bench.data, args[8], args[9]
    depth = geo.depth_from_plane(data.K_ref, args[7], x, y)
    want = bench.gt_plane[y.long(), x.long()]
    want = geo.depth_from_plane(data.K_ref, want, x, y)
    for i in (1, 3):
        np.testing.assert_allclose(n(depth[i]), n(want), rtol=1e-4)
    span = float((depth[0].max() - depth[0].min())
                 / (data.depth_max - data.depth_min))
    assert span > 0.8 if semantics == "reference" else span < 0.5


def test_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m",
                          "mpmvs_torch.tools.kernel_bench"],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()


@pytest.mark.parametrize("case", kernel_bench.SORTED_CASES)
def test_sorted_cases_build(case):
    """Each sorted-path case is a full-range field over the pixels the
    path sees there, and the plain chain scores it."""
    from mpmvs_torch.ops import ncc_sorted

    bench = kernel_bench.setup(48, 64, 4, 0, device="cpu")
    args = kernel_bench.sorted_inputs(bench, case)
    refside, plane, x, y, offs, cap = (args[0], args[7], args[8], args[9],
                                       args[10], args[12])
    shape = (48, 32) if case == "trial" else (48, 64)
    assert tuple(x.shape) == shape and tuple(plane.shape) == shape + (4,)
    assert tuple(refside.w.shape) == (len(offs),) + shape
    assert offs == bench.params.tap_offsets(0 if case == "trial" else 2)
    assert (cap > 0) == (case == "init-cap")
    depth = geo.depth_from_plane(bench.data.K_ref, plane, x, y)
    span = (depth.max() - depth.min()) / (bench.data.depth_max
                                          - bench.data.depth_min)
    assert float(span) > 0.8
    costs = ncc_sorted.ncc_eval_sorted(*args)
    assert costs.shape == (3,) + shape
    assert 0.0 < float((costs < 2.0).float().mean()) < 1.0


def test_bilateral_inputs_take_both_forms():
    from mpmvs_torch.ops import bilateral_cuda

    bench = kernel_bench.setup(48, 64, 4, 0, device="cpu")
    inputs = kernel_bench.bilateral_inputs(bench.color0, torch.device("cpu"))
    assert {g: bilateral_cuda.guide_form(bgr)
            for g, (bgr, _) in inputs.items()} == {"float": "float",
                                                  "8bit": "table"}
    for bgr, prob in inputs.values():
        assert bgr.shape == (48, 64, 3) and prob.shape == (48, 64)
        assert 0.0 <= float(prob.min()) and float(prob.max()) <= 1.0
    assert float((inputs["8bit"][0] - inputs["float"][0]).abs().max()) <= 0.5


SASS = """
	Function : _Z23bilateral_refine_kernelI5uint2EvPKfS2_S2_iiifPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00 */
        /*0010*/                   STS.64 [R3], R4 ;               /* 0x00 */
        /*0020*/                   LDS.64 R4, [R3] ;               /* 0x00 */
        /*0030*/                   LDS.64 R4, [R3] ;               /* 0x00 */
        /*0040*/                   LDS.64 R4, [R2+-0x120] ;        /* 0x00 */
        /*0050*/              @!P0 LDS R5, [R4] ;                  /* 0x00 */
        /*0060*/                   IDP.4A.U8.U8 R9, R5, R5, RZ ;   /* 0x00 */
        /*0070*/               @P2 BRA 0x90 ;                      /* 0x00 */
        /*0080*/                   LDS.64 R4, [R2+-0x110] ;        /* 0x00 */
        /*0090*/                   FADD R5, R4, -R8 ;              /* 0x00 */
        /*00a0*/               @P1 BRA 0x40 ;                      /* 0x00 */
        /*00b0*/                   LDS.64 R4, [R2] ;               /* 0x00 */
        /*00c0*/                   EXIT ;                          /* 0x00 */
	Function : _Z23bilateral_refine_kernelI6float4EvPKfS2_S2_iiifPf
        /*0000*/                   LDS.128 R4, [R2+-0x120] ;       /* 0x00 */
        /*0010*/                   MUFU.RSQ R5, R4 ;               /* 0x00 */
        /*0020*/                   CALL.REL.NOINC 0x40 ;           /* 0x00 */
        /*0030*/                   BRA 0x0 ;                       /* 0x00 */
        /*0040*/                   MUFU.EX2 R5, R4 ;               /* 0x00 */
	Function : _Z21bilateral_table_kernelfiPf
        /*0000*/                   LDS.128 R4, [R2] ;              /* 0x00 */
"""


def test_sass_count_takes_the_unrolled_row(monkeypatch):
    """Instructions a tap come from each form's loop (a branch back) with
    the most texel loads, one a tap; forward branches inside it and the
    staging before it do not cut or pad it; other kernels of the library
    are left out."""
    monkeypatch.setattr(kernel_bench.subprocess, "run",
                        lambda *a, **k: type("R", (), {"stdout": SASS}))
    got = kernel_bench.sass_per_tap("lib.so")
    assert got == {"table": (3.5, {"LDS": 1.5, "BRA": 1.0, "IDP": 0.5,
                                   "FADD": 0.5}),
                   "float": (4.0, {"LDS": 1.0, "MUFU": 1.0, "CALL": 1.0,
                                   "BRA": 1.0})}


GEOM_SASS = """
	Function : _Z16geom_cost_kernelILi2ELb0EEvPK6float4PKfS4_S4_S4_iiiiifPf
        /*0000*/                   LDG.E.128.CONSTANT R4, [R2.64] ;  /* 0x00 */
        /*0010*/                   LDS.64 R8, [R3] ;                /* 0x00 */
        /*0020*/                   FMUL R10, R8, R4 ;               /* 0x00 */
        /*0030*/                   LDG.E.CONSTANT R11, [R6.64] ;    /* 0x00 */
        /*0040*/                   STG.E [R12.64], R11 ;            /* 0x00 */
        /*0050*/                   FADD R13, R10, R11 ;             /* 0x00 */
        /*0060*/                   STG.E [R14.64], R13 ;            /* 0x00 */
        /*0070*/               @P1 BRA 0xb0 ;                       /* 0x00 */
        /*0080*/                   CALL.REL.NOINC 0x100 ;           /* 0x00 */
        /*0090*/                   STG.E [R12.64], R11 ;            /* 0x00 */
        /*00a0*/                   STG.E [R14.64], R13 ;            /* 0x00 */
        /*00b0*/               @P0 BRA 0x10 ;                       /* 0x00 */
        /*00c0*/               @P2 BRA 0x0 ;                        /* 0x00 */
        /*00d0*/                   EXIT ;                           /* 0x00 */
        /*0100*/                   MUFU.RCP R5, R4 ;                /* 0x00 */
	Function : _Z16geom_cost_kernelILi1ELb1EEvPK6float4PKfS4_S4_S4_iiiiifPf
        /*0000*/                   FADD R5, R4, R4 ;                /* 0x00 */
        /*0010*/                   STG.E [R12.64], R5 ;             /* 0x00 */
        /*0020*/               @P1 BRA 0x40 ;                       /* 0x00 */
        /*0030*/                   STG.E [R12.64], R6 ;             /* 0x00 */
        /*0040*/               @P0 BRA 0x0 ;                        /* 0x00 */
"""


def test_sass_count_takes_the_source_loop(monkeypatch):
    """Instructions an entry come from each geometric-cost instantiation's
    innermost loop with the most stores (the source loop, not the chunk
    loop around it), up to its chunk's last cost store: the recomputation
    after it and the called slow path are left out."""
    monkeypatch.setattr(kernel_bench.subprocess, "run",
                        lambda *a, **k: type("R", (), {"stdout": GEOM_SASS}))
    got = kernel_bench.sass_per_entry("lib.so")
    assert got == {(2, False): (3.0, {"STG": 1.0, "LDS": 0.5, "FMUL": 0.5,
                                      "LDG": 0.5, "FADD": 0.5}),
                   (1, True): (2.0, {"FADD": 1.0, "STG": 1.0})}


@pytest.mark.parametrize("case", kernel_bench.GEOM_CASES)
def test_geom_cases_build(case):
    """Each geometric-cost case holds K fields at the packed pixels of the
    geom band, and the plain twin scores them against every source."""
    from mpmvs_torch.ops import geom_cost

    bench = kernel_bench.setup(48, 64, 4, 0, device="cpu")
    args = kernel_bench.geom_inputs(bench, case)
    plane, x = args[11], args[12]
    K = {"gt": 1, "stack": 9, "trials": 5, "trial": 1}[case]
    assert tuple(x.shape) == (48, 32)
    assert tuple(plane.shape) == ((K,) if K > 1 else ()) + (48, 32, 4)
    depth = geo.depth_from_plane(bench.data.K_ref, plane, x, args[13])
    if case == "stack":
        assert torch.allclose(depth[8] / depth[0], torch.tensor(1.016),
                              rtol=1e-5)
    costs = geom_cost.geom_consistency_cost(*args)
    assert costs.shape == (3,) + tuple(plane.shape[:-1])
    real = (costs < bench.params.geom_cost_max).float()
    if case == "trials":
        # the random depths (trials 0 and 2) mostly miss, the rest hold
        assert torch.allclose(depth[4] / depth[1], torch.tensor(1.002),
                              rtol=1e-4)
        per_field = real.mean((0, 2, 3))
        assert bool((per_field[[0, 2]] < 0.5).all())
        assert bool((per_field[[1, 3, 4]] > 0.5).all())
    else:
        assert (float(real.mean()) > 0.5) if case != "trial" else (
            float(real.mean()) < 0.5)


@pytest.mark.parametrize("kernel", ["sorted", "bilateral", "geom", "colour",
                                    "j2k"])
def test_kernel_cases_exit_nonzero_without_cuda(kernel):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m",
                          "mpmvs_torch.tools.kernel_bench", "--kernel",
                          kernel, "--check"],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()


@pytest.mark.cuda
def test_colour_cases_equal_plain():
    """``--kernel colour`` at a small odd size: every case (the JPEG,
    YCCK and CMYK forms and the chunked form) equals its plain twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = kernel_bench.run_colour(2, True, H=37, W=94)
    assert [r["case"] for r in rows] == [c[0] for c in
                                         kernel_bench.COLOUR_CASES] + [
                                             "chunks_420"]
    assert all(r["entries_differing"] == 0 for r in rows)


@pytest.mark.cuda
def test_j2k_cases_equal_plain():
    """``--kernel j2k``: every level of the three sources and the three
    colour forms equal their twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = kernel_bench.run_j2k(2, True)
    assert {r["form"] for r in rows} == {53, 97, "none", "ict", "rct"}
    assert all(r["entries_differing"] == 0 for r in rows)
