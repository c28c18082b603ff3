"""mpmvs_torch.ops.threefry / ops.random against jax.random and
mpmvs_tpu.ops.random with the same keys.

Tolerances: key derivation, bits and uniform draws must match bit for bit
(integer hash; uniform is bits -> float plus one fused multiply-add, which
the port emulates exactly). ``normal`` goes through erf_inv, whose log1p and
sqrt may round an ulp apart: atol 1e-6 on N(0, 1) values. The derived
fields chain trig/normalization on the draws, each op within an ulp or two:
atol 1e-5 on unit normals and rtol 1e-5 on depths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import geometry as jgeo
from mpmvs_tpu.ops import random as jr
from mpmvs_torch.ops import random as tr
from mpmvs_torch.ops import threefry as tf

from torch_parity import n, t

torch.set_num_threads(1)

SEEDS = (0, 42, 2**31 + 5)


def _key(seed):
    return jax.random.PRNGKey(seed), tf.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bit_exact(seed):
    kj, kt = _key(seed)
    np.testing.assert_array_equal(np.asarray(kj).astype(np.int64), n(kt))
    for num in (2, 6):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(kj, num)).astype(np.int64),
            n(tf.split(kt, num)))
    for data in (0, 1, 101, 2**32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(kj, data)).astype(np.int64),
            n(tf.fold_in(kt, data)))


@pytest.mark.parametrize("shape", [(7,), (5, 9), (3, 4, 6)])
def test_bits_and_uniform_bit_exact(shape):
    kj, kt = _key(123)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(np.int64),
        n(tf.bits(kt, shape)))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape)),
                                  n(tf.uniform(kt, shape)))
    lo, hi = np.float32(0.37), np.float32(5.25)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, shape, minval=lo, maxval=hi)),
        n(tf.uniform(kt, shape, float(lo), float(hi))))


def test_normal_close():
    kj, kt = _key(9)
    a = np.asarray(jax.random.normal(kj, (4000,)))
    b = n(tf.normal(kt, (4000,)))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert (a == b).mean() > 0.9  # mostly bit-identical


def test_hash_u01_bit_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 5000, 600).astype(np.float32)
    b = rng.integers(0, 5000, 600).astype(np.float32)
    for seed in (0, 0xDEADBEEF, 12345):
        ref = np.asarray(jr._hash_u01(jnp.asarray(a), jnp.asarray(b),
                                      jnp.uint32(seed)))
        got = n(tr._hash_u01(t(a), t(b), torch.tensor(seed)))
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def grid():
    K = np.array([[160.0, 0, 64.0], [0, 150.0, 40.0], [0, 0, 1]], np.float32)
    xj, yj = jgeo.pixel_grid(80, 300)
    return K, xj, yj


@pytest.mark.parametrize("frac", [1.0 / 32.0, 1.0])
def test_smooth_banded_uniform(grid, frac):
    K, xj, yj = grid
    kj, kt = _key(5)
    (ks_j, kj_j), (ks_t, kj_t) = jax.random.split(kj), tf.split(kt)
    ref = np.asarray(jr.smooth_banded_uniform(ks_j, kj_j, xj, yj,
                                              jnp.float32(0.5),
                                              jnp.float32(6.0), frac))
    got = n(tr.smooth_banded_uniform(ks_t, kj_t, t(xj), t(yj),
                                     torch.tensor(0.5), torch.tensor(6.0),
                                     frac))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_normal_fields(grid):
    K, xj, yj = grid
    kj, kt = _key(77)
    x, y, Kt = t(xj), t(yj), t(K)
    np.testing.assert_allclose(
        n(tr.cone_normal_field(kt, Kt, x, y, np.pi / 3)),
        np.asarray(jr.cone_normal_field(kj, jnp.asarray(K), xj, yj,
                                        np.pi / 3)), atol=1e-5)
    np.testing.assert_allclose(
        n(tr.random_normal_field(kt, Kt, x, y)),
        np.asarray(jr.random_normal_field(kj, jnp.asarray(K), xj, yj)),
        atol=1e-5)
    base = np.zeros((80, 300, 3), np.float32)
    base[..., 2] = -1.0
    np.testing.assert_allclose(
        n(tr.perturbed_normal_field(kt, Kt, x, y, t(base), 0.02 * np.pi)),
        np.asarray(jr.perturbed_normal_field(kj, jnp.asarray(K), xj, yj,
                                             jnp.asarray(base),
                                             0.02 * np.pi)), atol=1e-5)
    d0, d1 = np.float32(1.0), np.float32(9.0)
    np.testing.assert_allclose(
        n(tr.random_plane_field(kt, Kt, x, y, float(d0), float(d1))),
        np.asarray(jr.random_plane_field(kj, jnp.asarray(K), xj, yj, d0, d1)),
        rtol=1e-5, atol=1e-5)
