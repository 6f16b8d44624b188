"""The hybrid product of a KMS phase-2 merge as one kernel launch.

`hybrid_product` takes a merge's components y_t [G, p1, N] on the 2^64
torus, party p1's rlk d-vector rd [l_uni, npr, N], the earlier parties'
public keys pub_h [p1-1, l_uni, npr, N] and the crs [l_uni, npr, N] (all
three as `kms.setup` stores them), and returns u [G, p1, npr, N] and
v [G, npr, N] as canonical residues (schemes/kms.py:_phase2_party_mat).
On CUDA tensors it launches csrc/hybrid_product.cu, one CTA per (gate,
prime) with the components' digits decomposed, transformed and contracted
in shared memory, and returns int32 residues; on CPU tensors it runs the
plain version, `kms._hybrid_product` (digits through the NTT, int64
products, in chunks of parties), which returns the same residues as int64.
The kernel replaces no Pallas kernel: the JAX package left this product to
XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ring.context import RingCtx
from ..ring.modring import MAX_PRODUCT_TERMS, prime_column
from . import _build
from .fused_mx3 import _sweep_consts
from .ntt import MAX_N, MAX_NPR, MIN_N, MIN_NPR, _kernel_tables

SOURCE = _build.CSRC / "hybrid_product.cu"
MAX_LOG_B = 16


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mktfhe_hybrid_product.argtypes = [ptr] * 9 + [ctypes.c_longlong] + [i32] * 5 + [ptr]
    lib.mktfhe_hybrid_product.restype = ctypes.c_int
    lib.mktfhe_hybrid_product_describe.argtypes = [i32, i32, i32, ptr]
    lib.mktfhe_hybrid_product_describe.restype = None
    return lib


def hybrid_kernel(params, ctx: RingCtx, lib=None) -> dict:
    """The kernel of csrc/hybrid_product.cu that serves this shape, as the
    source's dispatcher (`hybrid_plan`) says: its name with its template
    arguments as ptxas reports them (log2 N, l_uni, primes; zeros: run-time
    shapes), threads per CTA and dynamic shared memory.  `lib`: the library
    to ask (default: the built one)."""
    out = (ctypes.c_int * 5)()
    (lib or load_library()).mktfhe_hybrid_product_describe(ctx.n.bit_length() - 1, params.l_uni, ctx.nprimes, out)
    return {
        "name": "hybrid_product_kernel<" + ",".join(str(a) for a in out[:3]) + ">",
        "run_time_shapes": out[1] == 0,
        "threads": out[3],
        "shared_bytes": out[4],
    }


def _check(y_t, rd, pub_h, crs_hat, params, ctx: RingCtx) -> None:
    """Refuse what the kernel does not take, from the tensors' metadata
    alone (no read of their values, so a CUDA graph can capture the call)."""
    n, npr, l, log_b = ctx.n, ctx.nprimes, params.l_uni, params.log_b_uni
    if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0 and MIN_NPR <= npr <= MAX_NPR):
        raise ValueError(f"the hybrid product takes a power of two {MIN_N} <= N <= {MAX_N} and "
                         f"{MIN_NPR}-{MAX_NPR} primes, got N={n}, npr={npr}")
    if ctx.dtype != torch.int64:
        raise ValueError("the hybrid product works on the 2^64 torus")
    if not (1 <= l <= MAX_PRODUCT_TERMS and 1 <= log_b <= MAX_LOG_B and l * log_b <= 64):
        raise ValueError(f"the hybrid product takes l_uni <= {MAX_PRODUCT_TERMS}, log_b_uni <= {MAX_LOG_B} "
                         f"and l_uni * log_b_uni <= 64, got l_uni={l}, log_b_uni={log_b}")
    if y_t.dtype != torch.int64:
        raise TypeError(f"y_t must be int64 torus words, got {y_t.dtype}")
    if y_t.dim() != 3 or y_t.shape[1] < 1 or y_t.shape[2] != n:
        raise ValueError(f"y_t must be [G, p1, {n}] with p1 >= 1, got {tuple(y_t.shape)}")
    p1 = y_t.shape[1]
    keys = {"rd": (rd, (l, npr, n)), "pub_h": (pub_h, (p1 - 1, l, npr, n)), "crs_hat": (crs_hat, (l, npr, n))}
    for name, (t, shape) in keys.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 residues, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    for name, t in {"y_t": y_t, **{k: t for k, (t, _) in keys.items()}}.items():
        if t.device != y_t.device:
            raise ValueError(f"{name} lies on {t.device}, y_t on {y_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(y_t, rd, pub_h, crs_hat, params, ctx: RingCtx):
    n, npr = ctx.n, ctx.nprimes
    g, p1 = y_t.shape[0], y_t.shape[1]
    dev = y_t.device
    if g * npr >= 1 << 31:
        raise ValueError(f"{g * npr} (gate, prime) pairs exceed the kernel's grid")
    u = torch.empty((g, p1, npr, n), dtype=torch.int32, device=dev)
    v = torch.empty((g, npr, n), dtype=torch.int32, device=dev)
    if g == 0:
        return u, v
    lib = load_library()
    tw_f, tw_f_sh, _ = _kernel_tables(n, npr, True, dev)
    consts = _sweep_consts(n, npr, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mktfhe_hybrid_product(
            y_t.data_ptr(), rd.data_ptr(), pub_h.data_ptr(), crs_hat.data_ptr(), u.data_ptr(), v.data_ptr(),
            tw_f.data_ptr(), tw_f_sh.data_ptr(), consts.data_ptr(), g, p1, npr, params.l_uni,
            params.log_b_uni, n.bit_length() - 1, stream,
        )
    _build.check_launch(lib, err, "hybrid product kernel")
    hybrid_product.launches += 1
    return u, v


def hybrid_product(y_t, rd, pub_h, crs_hat, params, ctx: RingCtx):
    """The hybrid product of merge p1 = y_t.shape[1] -> (u [G, p1, npr, N],
    v [G, npr, N]) canonical residues: the CUDA kernel on CUDA tensors (one
    launch; int32), `kms._hybrid_product` on CPU tensors (int64).  Every
    tensor contiguous on one device; keys int32 residues."""
    _check(y_t, rd, pub_h, crs_hat, params, ctx)
    if y_t.device.type == "cpu":
        from ..schemes import kms  # kms imports this module

        return kms._hybrid_product(y_t, rd, pub_h, crs_hat, params, ctx, prime_column(ctx.nprimes, y_t.device))
    if y_t.device.type != "cuda":
        raise ValueError(f"no hybrid product for device {y_t.device}")
    return _launch(y_t, rd, pub_h, crs_hat, params, ctx)


# kernel launches since the last reset (CPU calls run the plain version and do not count)
hybrid_product.launches = 0


def reset_launches() -> None:
    hybrid_product.launches = 0
