"""Wrappers of the CUDA NTT kernels (csrc/ntt.cu), natural and batch-minor.

Port of mktfhe_tpu/kernels/ntt_pallas.py:_nat_call (`fwd_ntt_nat`,
`inv_ntt_nat`): drop-in replacements for ring.ntt.fwd_ntt/inv_ntt on
int32 residues [..., npr, N]; and of its `_make_call` (`fwd_ntt_pallas`,
`inv_ntt_pallas`, here `fwd_ntt_bm`, `inv_ntt_bm`): the same transform of
batch-minor residues [npr, R, N, G], the layout of kernels/batchminor.py,
read and written by the kernel itself.  On a CUDA tensor a wrapper launches
its kernel on the current stream or raises; on a CPU tensor it runs the
plain twin (ring/ntt.py; for batch-minor data over the permuted axes),
bit-identical.

Both kernels go round tiles with a persistent grid and a cp.async double
buffer and run the register-resident passes of csrc/modarith.cuh, with an
instance for each N from 64 to 2048: the natural one on tiles of 2048 words,
the batch-minor one on tiles of 4 or 8 consecutive gates of one (prime,
row), whichever the source's dispatcher picks for the shape, in clusters of
CTAs that together hold 32 gates and store whole 128-byte lines.  Which
instance serves a shape is decided in the source (`nat_plan`, `bm_plan`);
`nat_kernel` / `bm_kernel` ask it.  Every wrapper counts its launches, in
all and by shape (`launches`, `shapes`; `reset_launches`).

The kernels are compiled with nvcc at first use into mktfhe_tpu_torch/_build/
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
MIN_N, MAX_N = 64, 2048  # both kernels have an instance for each N between
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
    lib.mktfhe_ntt_bm.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ptr,
    ]
    lib.mktfhe_ntt_bm.restype = ctypes.c_int
    lib.mktfhe_ntt_nat_describe.argtypes = [ctypes.c_int, ctypes.c_int, ptr]
    lib.mktfhe_ntt_nat_describe.restype = None
    lib.mktfhe_ntt_bm_describe.argtypes = [ctypes.c_int] * 5 + [ptr]
    lib.mktfhe_ntt_bm_describe.restype = None
    return lib


def nat_kernel(n: int, forward: bool, lib=None) -> dict:
    """The instance of csrc/ntt.cu's natural kernel that serves N, as the
    source's dispatcher (`nat_plan`) says: its name as ptxas reports it,
    threads per CTA, polynomials per tile and dynamic shared memory (two
    tiles).  `lib`: the library to ask (default: the built one)."""
    out = (ctypes.c_int * 4)()
    (lib or load_library()).mktfhe_ntt_nat_describe(n.bit_length() - 1, int(forward), out)
    if out[0] == 0:
        raise ValueError(f"no natural NTT kernel for N={n}")
    return {
        "name": f"ntt_nat_kernel<{out[0]},{int(forward)}>",
        "threads": out[1],
        "polys_per_tile": out[2],
        "shared_bytes": out[3],
    }


def bm_kernel(n: int, npr: int, rows: int, gates: int, forward: bool, lib=None) -> dict:
    """The instance of csrc/ntt.cu's batch-minor kernel that serves a
    transform of [npr, rows, N, gates], as the source's dispatcher (`bm_plan`)
    says: its name as ptxas reports it, threads per CTA, gates per tile,
    dynamic shared memory (its tile buffers), the tiles its clusters walk
    (cluster x gates-per-tile gates of one polynomial each: a 128-byte line
    of every row for a full cluster) and the CTAs of a cluster.  `lib`: the
    library to ask (default: the built one)."""
    out = (ctypes.c_int * 6)()
    (lib or load_library()).mktfhe_ntt_bm_describe(n.bit_length() - 1, npr, rows, gates, int(forward), out)
    if out[0] == 0:
        raise ValueError(f"no batch-minor NTT kernel for N={n}")
    return {
        "name": f"ntt_bm_kernel<{out[0]},{out[2]},{int(out[5] > 1)},{int(forward)}>",
        "threads": out[1],
        "gates_per_tile": out[2],
        "shared_bytes": out[3],
        "tiles": out[4],
        "cluster": out[5],
    }


def _count(wrapper, shape: tuple) -> None:
    wrapper.launches += 1
    wrapper.shapes[shape] = wrapper.shapes.get(shape, 0) + 1


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


def _check_sizes(a: torch.Tensor, plan: NttPlan) -> None:
    """Refuse the ring sizes, prime counts and grids the kernels do not take."""
    n, npr = plan.n, plan.nprimes
    if not (MIN_N <= n <= MAX_N and MIN_NPR <= npr <= MAX_NPR):
        raise ValueError(f"the NTT kernel takes {MIN_N} <= N <= {MAX_N} and "
                         f"{MIN_NPR}-{MAX_NPR} primes, got N={n}, npr={npr}")
    if a.numel() // n >= 1 << 31:
        raise ValueError(f"{a.numel() // n} polynomials exceed the kernel's grid")


def _launch(a: torch.Tensor, plan: NttPlan, forward: bool) -> torch.Tensor:
    n, npr = plan.n, plan.nprimes
    _check_sizes(a, plan)
    polys = a.numel() // n
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
    _count(fwd_ntt_nat if forward else inv_ntt_nat, (polys // npr, npr, n))
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


def ntt_bm_plain(a: torch.Tensor, plan: NttPlan, forward: bool) -> torch.Tensor:
    """The plain version of the batch-minor kernel: ring.ntt.fwd_ntt /
    inv_ntt over the permuted axes, [npr, R, N, G] -> [R, G, npr, N] ->
    transform -> back."""
    transform = fwd_ntt if forward else inv_ntt
    return transform(a.permute(1, 3, 0, 2), plan).permute(2, 0, 3, 1).contiguous()


def _ntt_bm(a: torch.Tensor, plan: NttPlan, forward: bool) -> torch.Tensor:
    n, npr = plan.n, plan.nprimes
    if a.dtype != torch.int32:
        raise TypeError(f"NTT input must be int32 residues, got {a.dtype}")
    if a.dim() != 4 or a.shape[0] != npr or a.shape[2] != n:
        raise ValueError(f"batch-minor NTT input must be [{npr}, R, {n}, G], got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("NTT input must be contiguous")
    if a.device.type == "cpu":
        return ntt_bm_plain(a, plan, forward)
    if a.device.type != "cuda":
        raise ValueError(f"no NTT for device {a.device}")
    _check_sizes(a, plan)
    rows, gates = a.shape[1], a.shape[3]
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = load_library()
    tw, tw_sh, consts = _kernel_tables(n, npr, forward, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.mktfhe_ntt_bm(
            a.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), consts.data_ptr(),
            npr, rows, gates, n.bit_length() - 1, int(forward), stream,
        )
    _build.check_launch(lib, err, "batch-minor NTT kernel")
    _count(fwd_ntt_bm if forward else inv_ntt_bm, tuple(a.shape))
    return out


def fwd_ntt_bm(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward negacyclic NTT of batch-minor int32 residues [npr, R, N, G]
    (any G >= 1): the CUDA kernel on a CUDA tensor, ring.ntt.fwd_ntt over
    the permuted axes on a CPU one."""
    return _ntt_bm(a, plan, forward=True)


def inv_ntt_bm(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse negacyclic NTT (1/N folded) of batch-minor int32 residues
    [npr, R, N, G]: the CUDA kernel on a CUDA tensor, ring.ntt.inv_ntt over
    the permuted axes on a CPU one."""
    return _ntt_bm(a, plan, forward=False)


def reset_launches() -> None:
    """Every wrapper counts its kernel's launches since the last reset (CPU
    calls run the twin and do not count), also by shape (`shapes`): [rows,
    npr, N] for the natural ones, [npr, R, N, G] for the batch-minor ones."""
    for wrapper in (fwd_ntt_nat, inv_ntt_nat, fwd_ntt_bm, inv_ntt_bm):
        wrapper.launches = 0
        wrapper.shapes = {}


reset_launches()
