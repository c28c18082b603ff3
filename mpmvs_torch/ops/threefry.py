"""Threefry-2x32 counter-based random numbers on explicit key tensors.

The JAX package draws every random number through ``jax.random`` with the
threefry2x32 implementation in its partitionable mode
(``jax_threefry_partitionable=True``, the default of the JAX versions this
repository runs). This module computes the same functions with plain torch
integer ops, so both packages draw identical numbers from identical keys and
whole solves can be compared pixel by pixel:

  * ``PRNGKey``, ``split``, ``fold_in``, ``bits`` and ``uniform`` match
    ``jax.random`` bit for bit;
  * ``normal`` goes through the same single-precision ``erf_inv``
    polynomial as XLA (M. Giles, "Approximating the erfinv function") and
    matches to float rounding.

A key is an int64 tensor of shape (2,) that holds two uint32 words. uint32
arithmetic runs in int64 and is masked with ``& 0xFFFFFFFF``. Everything runs
on the device the key lives on, and keys are threaded through every call
explicitly, so runs are bit-reproducible on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: Tensor, d: int) -> Tensor:
    return ((v << d) | (v >> (32 - d))) & M32


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor):
    """The Threefry-2x32 block function (20 rounds) on uint32 words held in
    int64 tensors; the key words broadcast against the counters."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> Tensor:
    """Key from an integer seed, as ``jax.random.PRNGKey``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def _counts(n: int, device) -> tuple:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def split(key: Tensor, num: int = 2) -> Tensor:
    """(num, 2) new keys, as ``jax.random.split`` (partitionable mode: key i
    is the block function of counter (0, i))."""
    hi, lo = _counts(num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], -1)


def fold_in(key: Tensor, data) -> Tensor:
    """New key from ``key`` and a 32-bit integer, as ``jax.random.fold_in``."""
    d = torch.full((1,), int(data) & M32, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def bits(key: Tensor, shape) -> Tensor:
    """uint32 random bits (as int64) of ``shape``, as ``jax.random.bits``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    hi, lo = _counts(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _as_f32(v, device) -> Tensor:
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(v), device=device)


def fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 a * b + c with one rounding, as XLA's CPU backend contracts
    it: the float32 product is exact in float64, and the float64 sum rounds
    to the same float32 except in cases of double rounding (probability
    ~2^-29 per value)."""
    return (a.double() * b.double() + c.double()).float()


def uniform(key: Tensor, shape, minval=0.0, maxval=1.0) -> Tensor:
    """float32 U[minval, maxval) of ``shape``, as ``jax.random.uniform``:
    23 random mantissa bits under exponent 0, minus 1, scaled and shifted
    (one fused multiply-add, as XLA computes it), then floored at
    ``minval``."""
    b = bits(key, shape)
    fbits = (b >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = _as_f32(minval, key.device)
    hi = _as_f32(maxval, key.device)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


# XLA's single-precision erf_inv: w = -log1p(-x^2); a degree-8 polynomial in
# (w - 2.5) for w < 5, else in (sqrt(w) - 3), evaluated with fused
# multiply-adds; result p * x.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: Tensor) -> Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    v = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, c_lt), torch.full_like(x, c_ge))
        p = fma(p, v, c)
    out = p * x
    return torch.where(torch.abs(x) == 1.0, x * math.inf, out)


def normal(key: Tensor, shape) -> Tensor:
    """float32 standard normal of ``shape``, as ``jax.random.normal``:
    sqrt(2) erf_inv(U(nextafter(-1, 0), 1))."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(math.sqrt(2.0)).item() * erf_inv(u)
