"""The port's plain NCC (mpmvs_torch.ops.ncc_cuda on CPU tensors) against
the JAX package's Pallas kernel itself, ``ncc_eval_pallas_multi`` run in
interpret mode as tests/test_pallas.py runs it, at a tiny shape (one 8x128
tile, K=2: a ground-truth and a random plane field, 3 sources, footprint
cap on). Interpret mode is slow on the CPU, hence the one small case.

Tolerance: as test_torch_ncc.py — fewer than 1e-3 of the entries may differ
by more than 1e-4 (measured 0), because one ulp of a tap coordinate can
move a tap to another texel."""

import jax.numpy as jnp
import numpy as np
import torch

from mpmvs_tpu.ops import ncc as jncc
from mpmvs_tpu.ops.pallas_ncc import ncc_eval_pallas_multi
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import build_solve_data
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch.ops import ncc as tncc
from mpmvs_torch.ops import ncc_cuda

from test_torch_ncc import FRAC_TOL, _fields, _torch_args
from torch_parity import frac_beyond, t

torch.set_num_threads(1)


def test_plain_matches_pallas_interpret():
    scene = make_plane_scene(num_views=4, height=32, width=128, seed=7)
    params = JaxParams()
    data = build_solve_data(jnp.asarray(scene.images), scene.cameras)
    offs = tuple(params.tap_offsets(0))
    cap = params.cap_radius(0)
    x, y, gtp = _fields(scene, data, "gt", 1, 8, 8, 128)
    _, _, rnd = _fields(scene, data, "random", 1, 8, 8, 128)
    planes = jnp.concatenate([gtp, rnd])
    rj = jncc.ncc_refside(data.ref_img, 8, 8, offs, 5.0, 3.0)
    ref = np.asarray(ncc_eval_pallas_multi(
        rj, data.src_imgs, data.src_widths, data.src_heights, data.A, data.b,
        data.K_ref, planes, x, y, offs, params.cost_max, cap_radius=cap,
        interpret=True))
    rt = tncc.ncc_refside(t(data.ref_img), 8, 8, offs, 5.0, 3.0)
    got = ncc_cuda.ncc_eval_multi(rt, *_torch_args(data), t(planes), t(x),
                                  t(y), offs, params.cost_max, cap)
    assert got.shape == ref.shape == (2, 3, 8, 128)
    assert frac_beyond(got, ref, 1e-4) < FRAC_TOL
