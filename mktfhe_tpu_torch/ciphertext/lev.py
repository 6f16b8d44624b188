"""LEV / GSW over plain LWE (non-ring): gadget stacks of LWE ciphertexts.

Port of mktfhe_tpu/ciphertext/lev.py.  The schemes' key-switching keys are
LEV stacks in the original construction; here, as in the reference, they
are folded into int8 limb tables (schemes/common.py:build_ksk), so these
types serve protocol code that wants explicit leveled LWE objects.
Homomorphic add / subtract are wrapping adds of the stacks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ring.torus import to_carrier
from .keys import LweKey
from .lwe import lwe_encrypt, lwe_ith_encrypt
from .rlwe import gadget_gvec


class Lev(NamedTuple):
    """l LWE rows encrypting g_j * m: b [..., l], a [..., l, n]."""

    b: torch.Tensor
    a: torch.Tensor


class Gsw(NamedTuple):
    """The LEV of the b-row and n LEVs of the a-rows: b [..., n+1, l],
    a [..., n+1, l, n]; index 0 is the b-row."""

    b: torch.Tensor
    a: torch.Tensor


def _gadget_msgs(m, key: LweKey, l: int, log_b: int) -> torch.Tensor:
    """m [...] (torus values) -> m * g_j [..., l], wrapped in the key's
    carrier."""
    dtype, dev = key.key.dtype, key.key.device
    gvec = gadget_gvec(l, log_b, dtype, dev)
    m = torch.as_tensor(m, dtype=torch.int64, device=dev)
    return to_carrier(m[..., None] * gvec.long(), dtype)


def lev_encrypt(gen: torch.Generator, m, key: LweKey, sigma: float, l: int, log_b: int) -> Lev:
    """m scalar or [...] batch of torus values."""
    msgs = _gadget_msgs(m, key, l, log_b)
    ct = lwe_encrypt(gen, msgs, key, sigma, shape=tuple(msgs.shape))
    return Lev(b=ct.b, a=ct.a)


def lev_ith_encrypt(gen: torch.Generator, m, i: int, key: LweKey, sigma: float, l: int, log_b: int) -> Lev:
    """m * g_j added to mask coefficient a_i of each row."""
    msgs = _gadget_msgs(m, key, l, log_b)
    ct = lwe_ith_encrypt(gen, msgs, i, key, sigma, shape=tuple(msgs.shape))
    return Lev(b=ct.b, a=ct.a)


def gsw_encrypt(gen: torch.Generator, m, key: LweKey, sigma: float, l: int, log_b: int) -> Gsw:
    """The b-row LEV(m), then for each i the LEV with m * g_j on a_i."""
    rows = [lev_encrypt(gen, m, key, sigma, l, log_b)]
    rows += [lev_ith_encrypt(gen, m, i, key, sigma, l, log_b) for i in range(key.n)]
    return Gsw(b=torch.stack([r.b for r in rows], dim=-2), a=torch.stack([r.a for r in rows], dim=-3))


def lev_add(x: Lev, y: Lev) -> Lev:
    return Lev(b=x.b + y.b, a=x.a + y.a)


def lev_sub(x: Lev, y: Lev) -> Lev:
    return Lev(b=x.b - y.b, a=x.a - y.a)


def gsw_add(x: Gsw, y: Gsw) -> Gsw:
    return Gsw(b=x.b + y.b, a=x.a + y.a)


def gsw_sub(x: Gsw, y: Gsw) -> Gsw:
    return Gsw(b=x.b - y.b, a=x.a - y.a)
