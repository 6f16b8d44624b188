"""Wrapper of the CUDA natural-layout NTT kernel (csrc/ntt.cu).

Port of mktfhe_tpu/kernels/ntt_pallas.py:_nat_call (`fwd_ntt_nat`,
`inv_ntt_nat`): drop-in replacements for ring.ntt.fwd_ntt/inv_ntt on
int32 residues [..., npr, N].  On a CUDA tensor the wrapper launches the
kernel on the current stream or raises; on a CPU tensor it runs the plain
twin (ring/ntt.py), bit-identical.

The kernel is compiled with nvcc at first use into mktfhe_tpu_torch/_build/
(kernels/_build.py: a shared library with a plain C interface, loaded with
ctypes).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ring.ntt import NttPlan, fwd_ntt, inv_ntt, make_plan
from . import _build

SOURCE = _build.CSRC / "ntt.cu"
MIN_N, MAX_N = 64, 2048  # one polynomial per CTA: N/2 <= 1024 threads
MIN_NPR, MAX_NPR = 2, 4


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = _build.load(SOURCE)
    ptr = ctypes.c_void_p
    lib.mktfhe_ntt_nat.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ptr,
    ]
    lib.mktfhe_ntt_nat.restype = ctypes.c_int
    return lib


def _u32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


@functools.lru_cache(maxsize=None)
def _kernel_tables(n: int, nprimes: int, forward: bool, device):
    """(tw, tw_sh, consts) as u32 bits in int32 tensors on `device`."""
    plan = make_plan(n, nprimes)
    tw, tw_sh = (
        (plan.psi_brv, plan.psi_brv_shoup) if forward else (plan.ipsi_brv, plan.ipsi_brv_shoup)
    )
    consts = np.stack([plan.primes, plan.n_inv, plan.n_inv_shoup], axis=1)
    return tuple(_u32(t).to(device) for t in (tw, tw_sh, consts))


def _check(a: torch.Tensor, plan: NttPlan) -> None:
    if a.dtype != torch.int32:
        raise TypeError(f"NTT input must be int32 residues, got {a.dtype}")
    if a.dim() < 2 or tuple(a.shape[-2:]) != (plan.nprimes, plan.n):
        raise ValueError(f"NTT input must be [..., {plan.nprimes}, {plan.n}], got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("NTT input must be contiguous")


def _launch(a: torch.Tensor, plan: NttPlan, forward: bool) -> torch.Tensor:
    n, npr = plan.n, plan.nprimes
    if not (MIN_N <= n <= MAX_N and MIN_NPR <= npr <= MAX_NPR):
        raise ValueError(f"the NTT kernel takes {MIN_N} <= N <= {MAX_N} and "
                         f"{MIN_NPR}-{MAX_NPR} primes, got N={n}, npr={npr}")
    polys = a.numel() // n
    if polys >= 1 << 31:
        raise ValueError(f"{polys} polynomials exceed the kernel's grid")
    out = torch.empty_like(a)
    if polys == 0:
        return out
    lib = load_library()
    tw, tw_sh, consts = _kernel_tables(n, npr, forward, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.mktfhe_ntt_nat(
            a.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(),
            consts.data_ptr(), polys, npr, n.bit_length() - 1, int(forward), stream,
        )
    _build.check_launch(lib, err, "NTT kernel")
    (fwd_ntt_nat if forward else inv_ntt_nat).launches += 1
    return out


def fwd_ntt_nat(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward negacyclic NTT of int32 residues [..., npr, N]: the CUDA
    kernel on a CUDA tensor, the plain twin ring.ntt.fwd_ntt on a CPU one."""
    _check(a, plan)
    if a.device.type == "cpu":
        return fwd_ntt(a, plan)
    if a.device.type != "cuda":
        raise ValueError(f"no NTT for device {a.device}")
    return _launch(a, plan, forward=True)


def inv_ntt_nat(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse negacyclic NTT (1/N folded) of int32 residues [..., npr, N]:
    the CUDA kernel on a CUDA tensor, ring.ntt.inv_ntt on a CPU one."""
    _check(a, plan)
    if a.device.type == "cpu":
        return inv_ntt(a, plan)
    if a.device.type != "cuda":
        raise ValueError(f"no NTT for device {a.device}")
    return _launch(a, plan, forward=False)


# kernel launches since the last reset (CPU calls run the twin and do not count)
fwd_ntt_nat.launches = 0
inv_ntt_nat.launches = 0


def reset_launches() -> None:
    fwd_ntt_nat.launches = 0
    inv_ntt_nat.launches = 0
