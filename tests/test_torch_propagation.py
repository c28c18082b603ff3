"""One photometric half-iteration of mpmvs_torch against mpmvs_tpu: the same
JAX state (through ``mpmvs_torch.interop``), the same constants, the same
key and the same explicit ``band_rows`` (band b draws with fold_in(key, b),
so banding must agree), for each checkerboard phase.

Tolerance: per pixel, plane (atol 1e-4), cost (atol 1e-4) and view bitmask
(exact) are compared, and the fraction of pixels where any of them differs
is bounded by 2% (measured well below). Both packages draw the same random
numbers, so pixels differ only where a float tie flips an adoption: XLA
fuses multiply-adds on the CPU, eager PyTorch does not, so costs differ in
the last bits and a candidate within an ulp of the current cost can be
adopted by one and not the other. The inactive colour must be untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu.ops import propagation as jprop
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import _initial_state, build_solve_data
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch import interop
from mpmvs_torch.ops import ncc_cuda
from mpmvs_torch.ops import propagation as tprop

from torch_parity import n, t

torch.set_num_threads(1)

BAND_ROWS = 16
PARAMS = JaxParams(band_rows=BAND_ROWS)
FRAC_TOL = 0.02


@pytest.fixture(scope="module")
def setup():
    scene = make_plane_scene(num_views=3, height=48, width=64, seed=5)
    data = build_solve_data(jnp.asarray(scene.images), scene.cameras)
    key = jax.random.PRNGKey(17)
    k_init, k_step = jax.random.split(key)
    state = _initial_state(data, PARAMS, k_init, "photometric", None,
                           BAND_ROWS)
    tdata = tprop.SolveData(**{
        f: t(getattr(data, f)) for f in tprop.SolveData._fields
        if getattr(data, f) is not None})
    tstate = interop.state_from_numpy(*(np.asarray(a) for a in state))
    return data, state, tdata, tstate, k_step


@pytest.mark.parametrize("phase", [0, 1])
def test_checkerboard_step_matches(setup, phase):
    data, state, tdata, tstate, k_step = setup
    scale, it = 0, 1
    jout = jprop.checkerboard_step(state, data, PARAMS, scale, jnp.int32(it),
                                   phase, k_step, False, False, BAND_ROWS)
    tparams = interop.params_from_jax_fields(
        {f: getattr(PARAMS, f) for f in PARAMS.__dataclass_fields__})
    before = ncc_cuda.COUNTS.plain
    tout = tprop.checkerboard_step(tstate, tdata, tparams, scale, it, phase,
                                   interop.key_from_numpy(k_step),
                                   band_rows=BAND_ROWS)
    H = state.cost.shape[0]
    assert ncc_cuda.COUNTS.plain - before == 2 * (-(-H // BAND_ROWS))

    yy, xx = np.mgrid[0:H, 0:state.cost.shape[1]]
    active = (xx + yy) % 2 == phase
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(n(a)[~active], np.asarray(b)[~active])

    plane_d = np.abs(n(tout.plane) - np.asarray(jout.plane)).max(-1) > 1e-4
    cost_d = ~np.isclose(n(tout.cost), np.asarray(jout.cost), rtol=0,
                         atol=1e-4)
    sel_d = n(tout.sel) != np.asarray(jout.sel)
    differ = (plane_d | cost_d | sel_d)[active].mean()
    assert differ <= FRAC_TOL, differ
    # the step did real work: most active pixels changed their cost
    changed = (np.asarray(jout.cost) != np.asarray(state.cost))[active].mean()
    assert changed > 0.5, changed


def test_select_candidates_oracle():
    """The whole-image candidate harvest (the oracle form) picks the same
    neighbours as the JAX package (pure selection: exact)."""
    rng = np.random.default_rng(3)
    cost = rng.uniform(0, 2, (30, 34)).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.1] = np.inf
    plane = rng.normal(size=(30, 34, 4)).astype(np.float32)
    cj, vj = jprop.select_candidates(jnp.asarray(cost), jnp.asarray(plane))
    ct, vt = tprop.select_candidates(t(cost), t(plane))
    np.testing.assert_array_equal(n(ct), np.asarray(cj))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))


def test_band_geometry_and_halo():
    for scale in (0, 1, 2, 3):
        assert tprop.step_halo(scale) == jprop.step_halo(scale)
    for H, W, S in ((2130, 3200, 10), (64, 80, 2), (1001, 777, 20)):
        assert tprop.auto_band_rows(H, W, S, False, budget_mb=256) == \
            jprop.auto_band_rows(H, W, S, False)
        assert tprop._band_geometry(H, W, S, 1, False, 64) == \
            jprop._band_geometry(H, W, S, 1, False, 64)


def test_geom_and_prior_modes_raise(setup):
    """The geom and prior steps raise without their inputs (the solve data
    of a photometric solve has no source depths and no prior)."""
    data, state, tdata, tstate, k_step = setup
    key = interop.key_from_numpy(k_step)
    for geom, prior, lacks in ((True, False, "src_depths"),
                               (False, True, "prior_planes")):
        with pytest.raises(ValueError, match=lacks):
            tprop.checkerboard_step(tstate, tdata, PARAMS, 0, 0, 0, key,
                                    geom=geom, prior=prior)
