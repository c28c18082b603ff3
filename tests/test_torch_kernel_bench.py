"""mpmvs_torch.tools.kernel_bench on the CPU: its field builders against
the JAX tool's construction (tools/kernel_bench.py:86-108, through
mpmvs_tpu.ops.random) from the same key, its capture of a real band
step's NCC calls, and its refusal to run without a CUDA device.

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
