"""The mx evaluation order of the negacyclic NTT (port of kernels/mx_ntt.py).

The JAX package factors an N-point transform as N = 128 * nb: a 128-point
stage over a' (n = nb*a' + b') that its TPU kernels ran as limb matmuls, a
twiddle, and an nb-point merged-twist Cooley-Tukey transform over b'.  The
result is laid out as (k2', k1) flattened, k2' the bit-reversed index of the
nb-point stage: position k2'*128 + k1 holds the evaluation at

    psi^(2 * (k1 + 128 * bitrev(k2')) + 1).

Keys made by `fused_mx2.build_mx_kms_keys` are stored in that order, so the
order is what the port owes; the limb matrices and the chunked u64 matmul
served the TPU's matrix unit and are not carried over.  The plain transform
of the port (ring/ntt.py:fwd_ntt) evaluates at the same N points in
bit-reversed order, position t at psi^(2 * bitrev_logN(t) + 1), so the mx
order is a fixed permutation of it:

    mx_fwd_ref(x)[..., k2'*128 + k1] == fwd_ntt(x)[..., bitrev7(k1)*nb + k2']

(`mx_eval_index`), held against the JAX functions in
tests/test_torch_mx_ntt.py.  `mx_fwd_ref` is `fwd_ntt` followed by that
index, `mx_inv_ref` the inverse index followed by `inv_ntt`.

`to_mx_order` / `from_mx_order` are the JAX package's permuted COEFFICIENT
order, coeff_mx[b'*128 + a'] = coeff[nb*a' + b'], in which its kernels kept
the accumulator; the port's kernels keep the natural order and do not use it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ring.modring import _bitrev_perm
from ..ring.ntt import NttPlan, fwd_ntt, inv_ntt

NK = 128  # the factor of N whose index k1 stays in natural order


def _nb(n: int) -> int:
    if n < NK or n & (n - 1):
        raise ValueError(f"the mx order needs a power of two N >= {NK}, got N={n}")
    return n // NK


@functools.lru_cache(maxsize=None)
def _mx_eval_index_np(n: int) -> np.ndarray:
    nb = _nb(n)
    k2p, k1 = np.divmod(np.arange(n), NK)
    return _bitrev_perm(NK)[k1] * nb + k2p


@functools.lru_cache(maxsize=None)
def mx_eval_index(n: int, device) -> torch.Tensor:
    """idx [N] int64 with mx[..., pos] = std[..., idx[pos]]: where the plain
    transform's bit-reversed order holds the evaluation of mx position pos."""
    return torch.from_numpy(_mx_eval_index_np(n)).to(device)


@functools.lru_cache(maxsize=None)
def mx_eval_index_inv(n: int, device) -> torch.Tensor:
    """The inverse permutation: std[..., t] = mx[..., inv[t]]."""
    return torch.from_numpy(np.argsort(_mx_eval_index_np(n))).to(device)


@functools.lru_cache(maxsize=None)
def mx_odd_exponents(n: int) -> np.ndarray:
    """o [N] int64: mx position pos = k2'*128 + k1 evaluates at psi^o[pos],
    o = 2 * (k1 + 128 * bitrev(k2')) + 1."""
    nb = _nb(n)
    k2p, k1 = np.divmod(np.arange(n), NK)
    return 2 * (k1 + NK * _bitrev_perm(nb)[k2p]) + 1


def to_mx_order(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[..., N] coefficient order -> the permuted mx coefficient order,
    coeff_mx[b'*128 + a'] = coeff[nb*a' + b']."""
    lead = x.shape[:-1]
    return x.reshape(*lead, NK, nb).transpose(-1, -2).reshape(*lead, nb * NK)


def from_mx_order(x: torch.Tensor, nb: int) -> torch.Tensor:
    """Inverse of to_mx_order."""
    lead = x.shape[:-1]
    return x.reshape(*lead, nb, NK).transpose(-1, -2).reshape(*lead, nb * NK)


def mx_fwd_ref(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Exact forward transform into the mx evaluation order.  a: int32
    residues [..., npr, N] in natural coefficient order; returns int32
    [..., npr, N]."""
    return fwd_ntt(a, plan)[..., mx_eval_index(plan.n, a.device)]


def mx_inv_ref(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Exact inverse of mx_fwd_ref (natural coefficient order out)."""
    return inv_ntt(a[..., mx_eval_index_inv(plan.n, a.device)].contiguous(), plan)
