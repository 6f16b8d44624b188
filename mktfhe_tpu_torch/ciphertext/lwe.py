"""LWE ciphertexts over the discretized torus (port of ciphertext/lwe.py).

A ciphertext is {b: [...], a: [..., dim]} in the torus carrier dtype,
batched over arbitrary leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ring.sampler import gaussian_torus, uniform_torus
from ..ring.torus import to_carrier
from .keys import LweKey


class Lwe(NamedTuple):
    b: torch.Tensor  # [...]
    a: torch.Tensor  # [..., dim]


def wrap_dot(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """<x, key> along the last axis, wrapped in the torus of x's carrier."""
    return to_carrier((x * key).sum(-1), x.dtype)


def lwe_sample(gen: torch.Generator, key: LweKey, sigma: float, shape=()) -> Lwe:
    """Fresh encryption of zero: b = -<a, s> + e."""
    dtype = key.key.dtype
    a = uniform_torus(gen, (*shape, key.n), dtype)
    e = gaussian_torus(gen, shape, sigma, dtype)
    return Lwe(b=e - wrap_dot(a, key.key), a=a)


def lwe_encrypt(gen: torch.Generator, m: torch.Tensor, key: LweKey, sigma: float, shape=()) -> Lwe:
    """b += m; m (torus carrier) broadcastable to `shape`."""
    ct = lwe_sample(gen, key, sigma, shape)
    return Lwe(b=ct.b + m, a=ct.a)


def lwe_ith_encrypt(gen: torch.Generator, m: torch.Tensor, i: int, key: LweKey, sigma: float, shape=()) -> Lwe:
    """a[i] += m."""
    ct = lwe_sample(gen, key, sigma, shape)
    a = ct.a.clone()
    a[..., i] += m
    return Lwe(b=ct.b, a=a)


def phase(ct: Lwe, key: LweKey) -> torch.Tensor:
    """b + <a, s>."""
    return ct.b + wrap_dot(ct.a, key.key)


def lwe_add(x: Lwe, y: Lwe) -> Lwe:
    return Lwe(b=x.b + y.b, a=x.a + y.a)


def lwe_sub(x: Lwe, y: Lwe) -> Lwe:
    return Lwe(b=x.b - y.b, a=x.a - y.a)


def lwe_neg(x: Lwe) -> Lwe:
    return Lwe(b=-x.b, a=-x.a)
