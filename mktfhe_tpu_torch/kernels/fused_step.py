"""Fused CGGI blind-rotation step and the bootstrap built on it.

Port of mktfhe_tpu/kernels/fused_step.py (`make_cggi_step_kernel`,
`bootstrap_fused`): the whole per-step pipeline of the CGGI blind rotation

    gadget-decompose acc -> lift to CRT residues -> forward NTT ->
    external product with brk_i -> monomial weight (X^a - 1) ->
    inverse NTT -> Garner reconstruction -> acc += delta

as one CUDA kernel (csrc/cggi_step.cu) with the accumulator in registers and
every other intermediate in shared memory.  The TPU kernel did one step per launch inside a scan; this kernel
takes a range of steps [i0, i1) with the loop inside it and the accumulator
resident, so `bootstrap_fused` does the whole rotation in ONE launch (630
one-step launches cost the launch overhead and the accumulator's round trip
630 times; chip_smoke.py times both).  A launch over [i, i + 1) is the TPU
kernel's function, and `cggi_step_plain` below is its plain PyTorch version.

The accumulator is [G, 2, N] on the 2^32 torus (int32 carrier), one
contiguous polynomial per component, which is what `initial_acc` makes and
`keyswitch_table` takes: the TPU kernel's batch-minor transposes, its gate
tiles and its Shoup tables for keys and monomials have no counterpart.  The
keys are the batch-minor engine's `BmScheme` (kernels/batchminor.py), as in
the JAX package.  The arithmetic is exact, so the output is bit-identical to
schemes.cggi.bootstrap and kernels.batchminor.bootstrap_bm.

On CUDA tensors `cggi_step` launches the kernel or raises; on CPU tensors it
runs the plain version step by step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ciphertext.gsw import rlwe_decomp_hat
from ..ciphertext.lwe import Lwe
from ..ring.context import RingCtx
from ..ring.modring import mulsum_mod, prime_column
from ..ring.ntt import fwd_ntt, inv_ntt
from ..ring.torus import from_crt
from ..schemes.cggi import _ctx
from ..schemes.common import initial_acc, keyswitch_table, mod_switch_2n
from ..schemes.params import CggiParams
from ..utils.profiling import phase_range
from . import _build
from .batchminor import BmScheme
from .fused_mx3 import MAX_L_GSW, MAX_LOG_B, _sweep_consts, check_tildea_range
from .ntt import MAX_N, MAX_NPR, MIN_N, MIN_NPR, _kernel_tables

SOURCE = _build.CSRC / "cggi_step.cu"


def cggi_step_plain(acc: torch.Tensor, brk_i: torch.Tensor, ta_i: torch.Tensor, mono_hat: torch.Tensor, params: CggiParams, ctx: RingCtx) -> torch.Tensor:
    """The plain PyTorch version of one step of the kernel.

    acc: [G, 2, N] int32 torus; brk_i: [npr, 2l, 2, N] int32 (one step of
    `BmScheme.brk_bm`); ta_i: [G] integer rotation amounts, taken mod 2N
    (X^(a+2N) = X^a; the kernel reduces an int32 amount so too); mono_hat:
    [2N, npr, N].  Returns acc + Garner(INTT(mono(ta_i) * sum_j brk_i[j] *
    NTT(digits_j(acc)))), [G, 2, N] int32.
    """
    p = prime_column(ctx.nprimes, acc.device)
    g = acc.shape[0]
    dhat = rlwe_decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx, fwd_ntt)  # [G, 2, l, npr, N]
    x = dhat.reshape(g, 2 * params.l_gsw, 1, ctx.nprimes, ctx.n)
    ehat = mulsum_mod(x, brk_i.permute(1, 2, 0, 3), 1, p)  # [G, 2, npr, N]
    weighted = torch.remainder(ehat * mono_hat[torch.remainder(ta_i.long(), 2 * ctx.n)][:, None], p)
    return acc + from_crt(inv_ntt(weighted.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mktfhe_cggi_step.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_uint, ctypes.c_longlong,
        i32, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.mktfhe_cggi_step.restype = ctypes.c_int
    lib.mktfhe_cggi_step_describe.argtypes = [i32, i32, i32, ptr]
    lib.mktfhe_cggi_step_describe.restype = None
    return lib


def step_kernel(params: CggiParams, ctx: RingCtx, lib=None) -> dict:
    """The kernel of csrc/cggi_step.cu that serves this shape and how it is
    launched, as the source's own dispatcher (`step_plan`) says: its name with
    its template arguments as ptxas reports them (log2 N, l_gsw, primes,
    CTAs per SM; zeros: run-time shapes), threads per CTA, dynamic shared
    memory and whether the twiddles lie there.  `lib`: the library to ask
    (default: the built one)."""
    out = (ctypes.c_int * 7)()
    (lib or load_library()).mktfhe_cggi_step_describe(ctx.nprimes, params.l_gsw, ctx.n.bit_length() - 1, out)
    return {
        "name": "cggi_step_kernel<" + ",".join(str(a) for a in out[:4]) + ">",
        "run_time_shapes": out[0] == 0,
        "threads": out[4],
        "shared_bytes": out[5],
        "twiddles_in_shared": bool(out[6]),
    }


def _check(acc, tildea, brk_bm, mono_hat, params, ctx, i0, i1) -> None:
    """Refuse what the kernel does not take."""
    if not isinstance(params, CggiParams):
        raise TypeError(f"the CGGI step takes CggiParams, got {type(params).__name__}")
    n, npr = ctx.n, ctx.nprimes
    l, log_b = params.l_gsw, params.log_b_gsw
    if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0 and MIN_NPR <= npr <= MAX_NPR):
        raise ValueError(f"the CGGI step takes a power of two {MIN_N} <= N <= {MAX_N} and "
                         f"{MIN_NPR}-{MAX_NPR} primes, got N={n}, npr={npr}")
    if ctx.dtype != torch.int32 or params.k != 1:
        raise ValueError("the CGGI step works on the 2^32 torus at ring rank k = 1")
    if not (1 <= l <= MAX_L_GSW and 1 <= log_b <= MAX_LOG_B and l * log_b <= 32):
        raise ValueError(f"the CGGI step takes l_gsw <= {MAX_L_GSW}, log_b_gsw <= {MAX_LOG_B} "
                         f"and l_gsw * log_b_gsw <= 32, got l_gsw={l}, log_b_gsw={log_b}")
    if not 0 <= i0 <= i1 <= params.n:
        raise ValueError(f"steps [{i0}, {i1}) do not lie in [0, {params.n}]")
    g = acc.shape[0]
    shapes = {
        "acc": (acc, (g, 2, n)),
        "tildea": (tildea, (g, params.n)),
        "brk_bm": (brk_bm, (params.n, npr, 2 * l, 2, n)),
        "mono_hat": (mono_hat, (2 * n, npr, n)),
    }
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
        if t.device != acc.device:
            raise ValueError(f"{name} lies on {t.device}, acc on {acc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def cggi_step(acc: torch.Tensor, tildea: torch.Tensor, brk_bm: torch.Tensor, mono_hat: torch.Tensor, params: CggiParams, ctx: RingCtx, i0: int = 0, i1: int | None = None) -> torch.Tensor:
    """The blind-rotation steps [i0, i1) (default: all n) on every gate's
    accumulator: the CUDA kernel on CUDA tensors (one launch), a loop of
    `cggi_step_plain` on CPU tensors.

    acc: [G, 2, N] int32 torus (not written; the result is a new tensor);
    tildea: [G, n] int32 in [0, 2N); brk_bm: [n, npr, 2l, 2, N] and mono_hat:
    [2N, npr, N] int32 residues as in `BmScheme`; every tensor contiguous on
    one device.
    """
    i1 = params.n if i1 is None else i1
    _check(acc, tildea, brk_bm, mono_hat, params, ctx, i0, i1)
    check_tildea_range(tildea, ctx.n)  # the amounts index the 2N monomial images
    return _run(acc, tildea, brk_bm, mono_hat, params, ctx, i0, i1)


def _steps(acc, tildea, brk_bm, mono_hat, params: CggiParams, ctx: RingCtx) -> torch.Tensor:
    """All n steps of `cggi_step` for a tildea from `mod_switch_2n`: every
    check but the range read (`fused_mx3.check_tildea_range`)."""
    _check(acc, tildea, brk_bm, mono_hat, params, ctx, 0, params.n)
    return _run(acc, tildea, brk_bm, mono_hat, params, ctx, 0, params.n)


def _run(acc, tildea, brk_bm, mono_hat, params, ctx, i0, i1) -> torch.Tensor:
    if acc.device.type == "cpu":
        for i in range(i0, i1):
            acc = cggi_step_plain(acc, brk_bm[i], tildea[:, i], mono_hat, params, ctx)
        return acc
    if acc.device.type != "cuda":
        raise ValueError(f"no CGGI step for device {acc.device}")
    n, npr = ctx.n, ctx.nprimes
    gates = acc.shape[0]
    if gates >= 1 << 31:
        raise ValueError(f"{gates} gates exceed the kernel's grid")
    out = acc.clone()  # the kernel updates its accumulator in place
    if gates == 0 or i0 == i1:
        return out
    lib = load_library()
    dev = acc.device
    tw_f, tw_f_sh, _ = _kernel_tables(n, npr, True, dev)
    tw_i, tw_i_sh, _ = _kernel_tables(n, npr, False, dev)
    consts = _sweep_consts(n, npr, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mktfhe_cggi_step(
            out.data_ptr(), tildea.data_ptr(), brk_bm.data_ptr(), mono_hat.data_ptr(),
            tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
            consts.data_ptr(), ctx.crt.prod_mod32, gates, params.n, i0, i1, npr,
            params.l_gsw, params.log_b_gsw, n.bit_length() - 1, stream,
        )
    _build.check_launch(lib, err, "CGGI step kernel")
    cggi_step.launches += 1
    return out


# kernel launches since the last reset (CPU calls run the plain version and do not count)
cggi_step.launches = 0


def reset_launches() -> None:
    cggi_step.launches = 0


def bootstrap_fused(ct: Lwe, scheme: BmScheme, params: CggiParams) -> Lwe:
    """CGGI gate bootstrap with the fused step kernel: the whole blind
    rotation in one launch.  scheme: kernels.batchminor.BmScheme.
    Bit-identical to the other engines."""
    ctx = _ctx(params)
    with phase_range("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    with phase_range("mktfhe/rotate"):
        acc = initial_acc(tildeb, params.big_n, params.k, ctx.dtype)  # [G, 2, N]
        acc = _steps(acc, tildea.contiguous(), scheme.brk_bm, scheme.mono_hat, params, ctx)
    with phase_range("mktfhe/keyswitch"):
        return keyswitch_table(acc, scheme.ksk_b, scheme.ksk_a, params.f, params.log_d)
