"""Negacyclic number-theoretic transform over CRT primes (plain PyTorch).

Port of mktfhe_tpu/ring/ntt.py: the merged-twist negacyclic NTT (eprint
2016/504), Cooley-Tukey forward from natural to bit-reversed order,
Gentleman-Sande inverse back, with the 2N-th root psi folded into
bit-reversed twiddle tables and 1/N folded into the inverse.

`fwd_ntt`/`inv_ntt` here are the plain twins of the CUDA kernel in
mktfhe_tpu_torch/csrc/ntt.cu (wrapper: kernels/ntt.py): same tables, same
Shoup arithmetic, bit-identical output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .modring import (
    PRIMES,
    _bitrev_perm,
    _root_of_unity,
    addmod,
    prime_column,
    shoup,
    shoup_mul,
    submod,
)


class NttPlan(NamedTuple):
    """Host twiddle tables for a (N, nprimes) negacyclic NTT, as numpy u32.

    psi_brv[q, t] = psi_q^{bitrev(t)} for a primitive 2N-th root psi_q mod
    PRIMES[q]; ipsi_brv likewise for psi^{-1}; n_inv = N^{-1} mod p.  Each
    table has its Shoup companion floor(w * 2^32 / p).
    """

    n: int
    nprimes: int
    primes: np.ndarray  # [nprimes] uint32
    psi_brv: np.ndarray  # [nprimes, N] uint32
    psi_brv_shoup: np.ndarray
    ipsi_brv: np.ndarray
    ipsi_brv_shoup: np.ndarray
    n_inv: np.ndarray  # [nprimes] uint32
    n_inv_shoup: np.ndarray


@functools.lru_cache(maxsize=None)
def make_plan(n: int, nprimes: int) -> NttPlan:
    """Twiddle tables; copied from the reference's make_plan (ntt.py:59-94)."""
    assert n & (n - 1) == 0, "ring dimension must be a power of two"
    primes = PRIMES[:nprimes]
    rev = _bitrev_perm(n)

    psi_tabs, psi_sh, ipsi_tabs, ipsi_sh, ninvs, ninv_sh = [], [], [], [], [], []
    for p in primes:
        psi = _root_of_unity(p, 2 * n)
        ipsi = pow(psi, -1, p)
        pw = np.array([pow(psi, int(t), p) for t in range(n)], dtype=np.uint64)
        ipw = np.array([pow(ipsi, int(t), p) for t in range(n)], dtype=np.uint64)
        pb = pw[rev]
        ipb = ipw[rev]
        psi_tabs.append(pb.astype(np.uint32))
        ipsi_tabs.append(ipb.astype(np.uint32))
        psi_sh.append(np.array([shoup(int(w), p) for w in pb], dtype=np.uint32))
        ipsi_sh.append(np.array([shoup(int(w), p) for w in ipb], dtype=np.uint32))
        ninv = pow(n, -1, p)
        ninvs.append(ninv)
        ninv_sh.append(shoup(ninv, p))

    return NttPlan(
        n=n,
        nprimes=nprimes,
        primes=np.array(primes, dtype=np.uint32),
        psi_brv=np.stack(psi_tabs),
        psi_brv_shoup=np.stack(psi_sh),
        ipsi_brv=np.stack(ipsi_tabs),
        ipsi_brv_shoup=np.stack(ipsi_sh),
        n_inv=np.array(ninvs, dtype=np.uint32),
        n_inv_shoup=np.array(ninv_sh, dtype=np.uint32),
    )


class _Tables(NamedTuple):
    psi: torch.Tensor  # [npr, N] int64
    psi_sh: torch.Tensor
    ipsi: torch.Tensor
    ipsi_sh: torch.Tensor
    n_inv: torch.Tensor  # [npr, 1] int64
    n_inv_sh: torch.Tensor


@functools.lru_cache(maxsize=None)
def _tables(n: int, nprimes: int, device) -> _Tables:
    plan = make_plan(n, nprimes)

    def dev(x):
        return torch.from_numpy(x.astype(np.int64)).to(device)

    return _Tables(
        psi=dev(plan.psi_brv),
        psi_sh=dev(plan.psi_brv_shoup),
        ipsi=dev(plan.ipsi_brv),
        ipsi_sh=dev(plan.ipsi_brv_shoup),
        n_inv=dev(plan.n_inv)[:, None],
        n_inv_sh=dev(plan.n_inv_shoup)[:, None],
    )


def fwd_ntt(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward negacyclic NTT, natural -> bit-reversed order.

    a: int32 residues [..., nprimes, N] with values < p_i; returns int32.
    """
    n, npr = plan.n, plan.nprimes
    tab = _tables(n, npr, a.device)
    p = prime_column(npr, a.device)[..., None]  # [npr, 1, 1]
    lead = a.shape[:-2]
    a = a.long()
    m, t = 1, n
    while m < n:
        t //= 2
        x = a.reshape(*lead, npr, m, 2, t)  # block i pairs (a[j], a[j+t])
        s = tab.psi[:, m : 2 * m, None]
        s_sh = tab.psi_sh[:, m : 2 * m, None]
        u = x[..., 0, :]
        v = shoup_mul(s, s_sh, x[..., 1, :], p)
        a = torch.stack([addmod(u, v, p), submod(u, v, p)], dim=-2)
        a = a.reshape(*lead, npr, n)
        m *= 2
    return a.to(torch.int32)


def inv_ntt(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-reversed -> natural order, 1/N folded."""
    n, npr = plan.n, plan.nprimes
    tab = _tables(n, npr, a.device)
    p = prime_column(npr, a.device)[..., None]
    lead = a.shape[:-2]
    a = a.long()
    t, m = 1, n
    while m > 1:
        h = m // 2
        x = a.reshape(*lead, npr, h, 2, t)
        s = tab.ipsi[:, h : 2 * h, None]
        s_sh = tab.ipsi_sh[:, h : 2 * h, None]
        u = x[..., 0, :]
        v = x[..., 1, :]
        lo = shoup_mul(s, s_sh, submod(u, v, p), p)
        a = torch.stack([addmod(u, v, p), lo], dim=-2).reshape(*lead, npr, n)
        t *= 2
        m = h
    out = shoup_mul(tab.n_inv, tab.n_inv_sh, a, p[..., 0])
    return out.to(torch.int32)
