"""The geometric-consistency cost of mpmvs_torch on the CPU: the dispatcher,
the plain twin against mpmvs_tpu, and the kernel's arithmetic.

* ``ops.geom_cost.geom_consistency_cost`` sends CPU tensors to the plain
  twin (counted in ``geom_cost_cuda.COUNTS.plain``), never builds the
  kernel on the way, and refuses any other device; the kernel's wrapper
  refuses CPU tensors instead of running plain.
* The plain twin against ``mpmvs_tpu.ops.geom_cost.geom_consistency_cost``
  on hypotheses around the true plane: at most 1e-3 of the entries differ
  by more than 1e-4 px, as test_torch_geom.py holds it (a projected source
  coordinate within an ulp of a texel boundary can move the truncating
  fetch one texel over in one package). The K-stacked form equals
  per-field calls entry for entry.
* ``csrc/geom_cost.cu`` compiled for the host with g++ (its device code as
  written, ``-ffp-contract=off`` as ``-fmad=false`` on the card, IEEE
  division and square root on both), driven block by block as the card
  runs it: every thread's share of the shared camera table staged, then
  each thread through the instantiation the launch takes (chunks of 1, 3
  or 5 fields, 32- or 64-bit flat indices), over the wrapper's own launch
  arguments (``geom_cost_cuda.kernel_inputs``). On the host the kernel's
  branch-free fast paths of division and square root are the IEEE
  operators where the kernel keeps them and wrong outside that range, so
  an entry it fails to recompute shows. Equal to the plain twin entry for
  entry, the twin run with an IEEE square root (the CPU's vectorised
  ``torch.sqrt`` rounds an ulp off on some inputs; the card's is IEEE),
  with both index widths, on the cases of ``geom_cases``: K in {1, 4, 5,
  9, 13} (4 and 13 leave spare slots in their last chunk) with S in {1,
  10, 20}, pixel counts off the 128-thread block, any layout of planes
  and pixels, degenerate planes, zero, negative and non-finite source
  depths, projections off every edge, sources narrower, shorter, wider
  and taller than the padded stack and of zero extent (the negative flat
  index that wraps), and exactly zero dividends and squared errors. The
  kernel on the card is held to the same equality in
  test_torch_kernel_cuda.py. The wrapper takes 64-bit indices from 2^31
  stack entries on.
* The solver reaches the function through the module attribute
  ``propagation.geom_consistency_cost`` at every call, twice a geom band
  step: K=9 (the 8 original candidates, then the current plane) and K=5
  (the 5 trials), so the bench's ``geom_cost_zero`` control and
  ``solve_trace``'s profiler range, which replace it, reach every call.
  The stacked calls give the step that per-field calls give, exactly
  (both through the twin with an IEEE square root). The camera table is
  built once a solve, with its ``SolveData``, and every call gets it.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu.ops import geom_cost as jgc
from mpmvs_tpu.solver import build_solve_data as jax_build_solve_data
from mpmvs_tpu.utils.synthetic import make_plane_scene as jax_plane_scene
from mpmvs_torch.ops import geom_cost as tgc
from mpmvs_torch.ops import geom_cost_cuda, nvcc
from mpmvs_torch.ops import propagation as tprop
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch import solver as tsolver
from mpmvs_torch.solver import build_solve_data, initial_state, solve_view
from mpmvs_torch.utils.synthetic import make_plane_scene

import geom_cases as gc
from torch_parity import cams as torch_cams
from torch_parity import frac_beyond, n, t

torch.set_num_threads(1)

H, W = gc.H, gc.W


@pytest.fixture(scope="module")
def scene_data():
    return gc.scene_data("cpu")


# ---- the dispatcher


def test_dispatch_takes_the_plain_twin_on_the_cpu(scene_data):
    scene, data = scene_data
    x, y = gc.packed(data, 7, 20)
    plane = gc.planes(scene, data, 1, 0, x, y)[0]
    cams = gc.cams(data)
    geom_cost_cuda.COUNTS.reset()
    got = gc.call(tgc.geom_consistency_cost, cams, plane, x, y)
    want = gc.call(tgc.geom_consistency_cost_plain, cams, plane, x, y)
    assert (geom_cost_cuda.COUNTS.kernel, geom_cost_cuda.COUNTS.plain) == \
        (0, 1)
    assert got.shape == (3, 7, 20) and torch.equal(got, want)
    assert geom_cost_cuda._library.cache_info().currsize == 0  # no build


def test_kernel_wrapper_refuses_cpu_tensors(scene_data):
    scene, data = scene_data
    x, y = gc.packed(data, 4, 8)
    plane = gc.planes(scene, data, 1, 1, x, y)[0]
    geom_cost_cuda.COUNTS.reset()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gc.call(geom_cost_cuda.geom_consistency_cost_kernel, gc.cams(data),
                plane, x, y)
    assert (geom_cost_cuda.COUNTS.kernel, geom_cost_cuda.COUNTS.plain) == \
        (0, 0)


def test_dispatch_refuses_other_devices(scene_data):
    _, data = scene_data
    meta = {f: torch.empty(a.shape, device="meta")
            for f, a in gc.cams(data).items()}
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no geometric-cost implementation"):
        gc.call(tgc.geom_consistency_cost, meta,
                torch.empty((4, 8, 4), device="meta"), x, x)


# ---- the plain twin against the JAX package


def test_plain_twin_matches_jax_and_stacks():
    scene = jax_plane_scene(num_views=3, height=H, width=W, seed=4)
    rng = np.random.default_rng(11)
    src = (scene.gt_depth[1:] * rng.uniform(0.99, 1.01, (2, H, W))).astype(
        np.float32)
    src[rng.uniform(size=src.shape) < 0.05] = 0.0
    jdata = jax_build_solve_data(jnp.asarray(scene.images), scene.cameras,
                                 jnp.asarray(src))
    args = [getattr(jdata, f) for f in gc.CAM_FIELDS]
    tdata = build_solve_data(torch.as_tensor(scene.images),
                             torch_cams(scene.cameras), torch.as_tensor(src))
    x, y = gc.packed(tdata, H, W, 0, 0)
    planes = gc.planes(scene, tdata, 3, 5, x, y, wild=False)
    cj = np.stack([np.asarray(jgc.geom_consistency_cost(
        *args, jnp.asarray(n(p)), jnp.asarray(n(x)), jnp.asarray(n(y))))
        for p in planes], 1)
    ct = tgc.geom_consistency_cost_plain(*[t(a) for a in args], planes, x, y)
    assert ct.shape == cj.shape == (2, 3, H, W)
    assert ((cj < 3.0) & (n(ct) < 3.0)).mean() > 0.5 and (cj == 3.0).any()
    assert frac_beyond(ct, cj, 1e-4) <= 1e-3
    for k in range(3):
        assert torch.equal(ct[:, k], tgc.geom_consistency_cost_plain(
            *[t(a) for a in args], planes[k], x, y))


# ---- the kernel's arithmetic, compiled for the host

HOST_PRELUDE = r"""
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __syncthreads()
#define __ldg(p) (*(p))
#define cudaErrorInvalidValue 1
struct float4 { float x, y, z, w; };
struct Dim3 { unsigned x, y; };
static Dim3 threadIdx, blockIdx, gridDim;
using std::min;
// cvt.rzi.s32.f32: truncating, saturating, NaN -> 0
static inline int __float2int_rz(float v) {
  if (v != v) return 0;
  if (v >= 2147483648.0f) return 2147483647;
  if (v <= -2147483648.0f) return -2147483647 - 1;
  return (int)v;
}
static inline unsigned __float_as_uint(float v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}
// the fast paths: IEEE where the kernel keeps them, wrong elsewhere
#define GEOM_HOST_DIV(a, b) \
  (div_operand(a) & div_operand(b) ? (a) / (b) : (a) / (b) * 1.5f + 1.0f)
#define GEOM_HOST_SQRT(x) (sqrt_operand(x) ? sqrtf(x) : sqrtf(x) + 1.0f)
"""

HOST_LAUNCH = r"""
float cam[GEOM_REF_FLOATS + GEOM_SRC_FLOATS * GEOM_MAX_SOURCES];

// the launch, block by block: every thread's share of the camera table is
// staged before the block's threads run (each thread repeats its share),
// then the threads run in turn through the instantiation the launch takes
extern "C" void geom_cost_host(const float* planes, const float* x,
                               const float* y, const float* depths,
                               const float* cams, int K, int S, int P,
                               int Hs, int Ws, float max_cost, int wide,
                               float* out) {
  const GeomKernel kernel = geom_kernel_for(K, wide);
  gridDim.x = (P + GEOM_THREADS - 1) / GEOM_THREADS;
  for (blockIdx.x = 0; blockIdx.x < gridDim.x; ++blockIdx.x) {
    for (threadIdx.x = 0; threadIdx.x < GEOM_THREADS; ++threadIdx.x)
      geom_stage(cams, S, Hs, Ws);
    for (threadIdx.x = 0; threadIdx.x < GEOM_THREADS; ++threadIdx.x)
      kernel(reinterpret_cast<const float4*>(planes), x, y, depths, cams, K,
             S, P, Hs, Ws, max_cost, out);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/geom_cost.cu``'s kernel up to its launch function, built with
    g++ for the host."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the kernel's arithmetic")
    with open(f"{nvcc.CSRC}/{geom_cost_cuda.SOURCE}") as f:
        text = f.read()
    body = text[:text.index('extern "C"')]
    assert re.search(r"__global__ void\s[^;{]*geom_cost_kernel\(", body)
    d = tmp_path_factory.mktemp("geom_host")
    (d / "host.cpp").write_text(HOST_PRELUDE + body + HOST_LAUNCH)
    # the shared table holds the extents' int32 bits among the floats
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-fno-strict-aliasing", "-shared", "-fPIC", "-std=c++17",
                    "-o", str(d / "host.so"), str(d / "host.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(d / "host.so"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.geom_cost_host.argtypes = [vp] * 5 + [i] * 5 + [ctypes.c_float, i,
                                                         vp]

    def launcher(wide: bool):
        def run(*args):
            *cams, plane, x, y, max_cost = args
            a = geom_cost_cuda.kernel_inputs(*cams, plane, x, y)
            S, Hs, Ws = a.depths.shape
            out = torch.empty((S,) + a.lead, dtype=torch.float32)
            lib.geom_cost_host(a.planes.data_ptr(), a.x.data_ptr(),
                               a.y.data_ptr(), a.depths.data_ptr(),
                               a.cams.data_ptr(), a.K, S, a.P, Hs, Ws,
                               max_cost, int(wide), out.data_ptr())
            return out
        return run
    return launcher


def _ieee_sqrt(a):
    """The correctly rounded float32 square root: through float64, whose
    53 bits make the second rounding exact."""
    return SQRT(a.double()).float()


SQRT = torch.sqrt


def _check(host_kernel, monkeypatch, cases):
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    for c, plane, x, y, cap in cases:
        want = gc.call(tgc.geom_consistency_cost_plain, c, plane, x, y, cap)
        assert gc.same(gc.call(host_kernel, c, plane, x, y, cap), want)
        assert bool((want < cap).any()) and bool((want == cap).any())


@pytest.mark.parametrize("wide", [False, True], ids=["index32", "index64"])
@pytest.mark.parametrize("S", [1, 10, 20])
@pytest.mark.parametrize("K", [1, 4, 5, 9, 13])
def test_host_kernel_equals_plain(scene_data, host_kernel, monkeypatch, K,
                                  S, wide):
    _check(host_kernel(wide), monkeypatch,
           gc.stacked_case(*scene_data, K, S))


@pytest.mark.parametrize("wide", [False, True], ids=["index32", "index64"])
@pytest.mark.parametrize("case", ["layout", "degenerate", "edge", "axis"])
def test_host_kernel_equals_plain_on_hard_inputs(scene_data, host_kernel,
                                                 monkeypatch, case, wide):
    """Any layout of planes and pixels; degenerate planes; the sources'
    edges and non-finite depths; zero dividends and a zero squared error,
    which the fast paths leave to the IEEE operators (``geom_cases``)."""
    cases = {"layout": gc.layout_cases, "degenerate": gc.degenerate_case,
             "edge": gc.edge_cases, "axis": gc.axis_case}[case](*scene_data)
    _check(host_kernel(wide), monkeypatch, cases)


def test_wrapper_picks_the_index_width():
    """32-bit flat indices below 2^31 stack entries, 64-bit from there
    on; the bench's stack (10 x 2130 x 3200) takes 32."""
    wide = geom_cost_cuda.wide_index
    assert not wide(10, 2130, 3200)
    assert not wide(1, 1, 2 ** 31 - 1) and wide(1, 1, 2 ** 31)
    assert not wide(2, 32768, 32767) and wide(2, 32768, 32768)
    assert wide(448, 4096, 4096)


# ---- the solver's call site


def test_band_step_looks_the_function_up_at_every_call(scene_data,
                                                       monkeypatch):
    """A geom half-iteration calls propagation.geom_consistency_cost twice
    a band, K=9 (the 8 candidates and the current plane) then K=5 (the
    trials), through the module attribute that the bench's control and
    solve_trace replace, with the solve's camera table; on the CPU every
    call reaches the plain twin."""
    _, data = scene_data
    params = PatchMatchParams(max_scale=0, max_iterations=1)
    key = tf.PRNGKey(5)
    state = initial_state(data, params, key, 16)
    seen = []
    dispatch = tprop.geom_consistency_cost

    def counted(*args, **kwargs):
        seen.append((tuple(args[11].shape), kwargs["cams"]))
        return dispatch(*args, **kwargs)

    monkeypatch.setattr(tprop, "geom_consistency_cost", counted)
    geom_cost_cuda.COUNTS.reset()
    out = tprop.checkerboard_step(state, data, params, 0, 0, 0,
                                  tf.fold_in(key, 1), geom=True,
                                  band_rows=16)
    bands = -(-H // 16)
    assert len(seen) == 2 * bands
    Wh = W // 2
    assert [shape[0] for shape, _ in seen] == [9, 5] * bands
    assert all(shape == (shape[0], 16, Wh, 4) for shape, _ in seen)
    assert all(cams is data.geom_cams for _, cams in seen)
    assert geom_cost_cuda.COUNTS.plain == 2 * bands
    assert geom_cost_cuda.COUNTS.kernel == 0
    assert bool(torch.isfinite(out.geom_cost).all())


def _per_field(*args, cams=None):
    """The geometric cost of K stacked fields as K one-field calls of the
    twin, the band step's calls before they were stacked."""
    *c, planes, x, y, cap = args
    return torch.stack([tgc.geom_consistency_cost_plain(*c, p, x, y, cap)
                        for p in planes], 1)


@pytest.mark.parametrize("prior", [False, True], ids=["geom", "geom_prior"])
def test_stacked_band_step_equals_per_field_calls(scene_data, monkeypatch,
                                                  prior):
    """One geom half-iteration (two bands) with the two stacked calls
    against the same step with a one-field call a field, both through the
    twin: plane, cost, geometric cost and views equal entry for entry.
    Both arms take the IEEE square root: the CPU's vectorised torch.sqrt
    can part a stacked and a one-field call by an ulp."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    scene, data = scene_data
    params = PatchMatchParams(max_scale=0, max_iterations=1)
    key = tf.PRNGKey(9)
    if prior:
        y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                              torch.arange(W, dtype=torch.float32),
                              indexing="ij")
        planes = gc.planes(scene, data, 1, 4, x, y, wild=False)[0]
        mask = torch.as_tensor(
            np.random.default_rng(2).uniform(size=(H, W)) < 0.6)
        data = data._replace(prior_planes=planes, prior_mask=mask)
    state = initial_state(data, params, key, 16)
    step = lambda: tprop.checkerboard_step(
        state, data, params, 0, 0, 1, tf.fold_in(key, 3), geom=True,
        prior=prior, band_rows=24)
    stacked = step()
    monkeypatch.setattr(tprop, "geom_consistency_cost", _per_field)
    fields = step()
    for a, b in zip(stacked, fields):
        assert gc.same(a, b)
    assert not torch.equal(stacked.plane, state.plane)


def test_camera_table_is_built_once_a_solve(monkeypatch):
    """A geom solve builds the geometric-cost kernel's camera table once,
    with its SolveData, and hands that one tensor to every call."""
    scene = make_plane_scene(num_views=3, height=32, width=48, seed=2)
    params = PatchMatchParams(max_scale=0, max_iterations=1,
                              geom_iterations=2)
    key = tf.PRNGKey(0)
    warm = solve_view(scene.images, scene.cameras, key, params,
                      device="cpu")
    built, passed = [], []
    table = tsolver.camera_table

    def counted_table(*args):
        built.append(table(*args))
        return built[-1]

    dispatch = tprop.geom_consistency_cost

    def counted(*args, **kwargs):
        passed.append(kwargs["cams"])
        return dispatch(*args, **kwargs)

    monkeypatch.setattr(tsolver, "camera_table", counted_table)
    monkeypatch.setattr(tprop, "geom_consistency_cost", counted)
    solve_view(scene.images, scene.cameras, key, params, "geom",
               device="cpu", warm=warm,
               src_depths=np.asarray(scene.gt_depth[1:]))
    bands = -(-32 // tsolver.solve_band_rows(params, 32, 48, 2, True))
    assert len(built) == 1
    assert len(passed) == 2 * params.geom_iterations * 2 * bands
    assert all(c is built[0] for c in passed)
    cams = scene.cameras
    assert torch.equal(built[0], table(
        2, cams.K[0], cams.R[0], cams.C[0], cams.t[0], cams.K[1:],
        cams.R[1:], cams.t[1:], cams.C[1:], cams.width[1:],
        cams.height[1:]))
