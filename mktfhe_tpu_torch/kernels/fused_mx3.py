"""KMS phase-1 sweep and the bootstrap built on it.

Port of mktfhe_tpu/kernels/fused_mx3.py (`make_mx3_sweep_kernel`,
`kms_phase1_mx3`, `bootstrap_mx3`): one party's whole phase-1 blind
rotation as ONE kernel launch with the 2^64 RLEV accumulator resident over
all steps (csrc/phase1_sweep.cu), then the lev key through the NTT kernel,
then phase 2 and the key switch of schemes/kms.py unchanged.

The edge of the kernel is the torus accumulator [G, rows, 2, N], and the
arithmetic is exact, so its output is bit-identical to `phase1_sweep_plain`
below -- the loop that schemes/kms.py:phase1 / phase1_block run -- whatever
happens inside.  What the TPU kernel owed to its hardware (limb matmuls on
the matrix unit, the mx coefficient order, u32 pair arithmetic, gate tiles,
row chunks, digit-split planes for wide gadgets, Shoup tables for the keys)
has no counterpart here.  In particular the JAX package's mx-domain key
container `MxKmsKeys` and `build_mx3_kms_keys` do not exist in the port:
the sweep reads `KmsScheme.brk_hat` and `KmsScheme.mono_hat` as `kms.setup`
stores them, so there is no second image of the keys.

On a CUDA tensor `phase1_sweep` launches the kernel or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ciphertext.gsw import external_product_hat, rlwe_decomp_hat
from ..ciphertext.lwe import Lwe
from ..ciphertext.rlwe import gadget_gvec
from ..ring.context import RingCtx
from ..ring.modring import MAX_PRODUCT_TERMS, PRIMES, prime_column, shoup
from ..ring.ntt import fwd_ntt, inv_ntt
from ..ring.torus import from_crt, lift, negacyclic_roll
from ..schemes.params import KmsBlockParams, KmsParams
from . import _build
from .ntt import MAX_N, MAX_NPR, MIN_N, MIN_NPR, _kernel_tables, fwd_ntt_nat

SOURCE = _build.CSRC / "phase1_sweep.cu"
MAX_L_GSW = 6  # 2l digit polynomials of N u32 in shared memory (KMS32party)
MAX_LOG_B = 16
_CONST_COLS = 10  # csrc/phase1_sweep.cu:kConstCols


def phase1_init(iter_rows: int, params, ctx: RingCtx, g: int, device) -> torch.Tensor:
    """RLEV accumulator rows [G, rows, 2, N] carrying the LEV gadget
    constants at coefficient 0 of component 0."""
    gvec = gadget_gvec(params.l_lev, params.log_b_lev, ctx.dtype, device)[:iter_rows]
    acc = torch.zeros((g, iter_rows, 2, ctx.n), dtype=ctx.dtype, device=device)
    acc[:, :, 0, 0] = gvec
    return acc


def _ell(params) -> int:
    return params.ell if isinstance(params, KmsBlockParams) else 1


def phase1_sweep_plain(tildea_p, brk_hat_p, iter_rows: int, mono_hat, params, ctx: RingCtx,
                       acc0: torch.Tensor | None = None, ntt=(fwd_ntt, inv_ntt)) -> torch.Tensor:
    """The plain PyTorch version of the sweep kernel.

    tildea_p: [G, n] rotation amounts in [0, 2N); brk_hat_p:
    [n, 2, l, 2, npr, N] int32 (one party's `KmsScheme.brk_hat`); mono_hat:
    [2N, npr, N] (block parameters; unused otherwise).  Returns the torus
    accumulator [G, rows, 2, N] int64 after all steps, starting from `acc0`
    (default: the LEV gadget rows of `phase1_init`).

    Binary keys: per key bit, acc += X^a e - e with e the external product
    brought back to the torus.  Block keys: per block one decomposition and
    forward transform, the ell members' external products weighted by the
    images of X^{a_m} - 1 and summed in the evaluation domain, one inverse.
    `ntt` is the (forward, inverse) transform pair: the plain transforms
    here; schemes/kms.py passes the NTT kernel's wrappers.
    """
    fwd, inv = ntt
    g = tildea_p.shape[0]
    acc = phase1_init(iter_rows, params, ctx, g, tildea_p.device) if acc0 is None else acc0

    def decomp_hat(x):
        return rlwe_decomp_hat(x, params.l_gsw, params.log_b_gsw, ctx, fwd)

    def to_torus(r):
        return from_crt(inv(r.to(torch.int32), ctx.plan), ctx.crt, ctx.dtype)

    if not isinstance(params, KmsBlockParams):
        for j in range(params.n):
            e = to_torus(external_product_hat(decomp_hat(acc), brk_hat_p[j], ctx))
            acc = acc + negacyclic_roll(e, tildea_p[:, j, None, None]) - e
        return acc

    ell, d = params.ell, params.d
    if ell > MAX_PRODUCT_TERMS:
        raise ValueError(f"ell = {ell} member products would overflow int64 before the reduction")
    p = prime_column(ctx.nprimes, tildea_p.device)
    brk = brk_hat_p.reshape(d, ell, *brk_hat_p.shape[1:])
    ta = tildea_p.long().reshape(g, d, ell)
    for blk in range(d):
        dhat = decomp_hat(acc)
        tacc = 0
        for m in range(ell):
            ehat = external_product_hat(dhat, brk[blk, m], ctx)  # [G, rows, 2, npr, N]
            tacc = tacc + ehat * mono_hat[ta[:, blk, m]][:, None, None]
        acc = acc + to_torus(torch.remainder(tacc, p))
    return acc


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mktfhe_phase1_sweep.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_ulonglong, ctypes.c_longlong,
        i32, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.mktfhe_phase1_sweep.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sweep_consts(n: int, nprimes: int, device) -> torch.Tensor:
    """Per-prime constants [npr, 10] as u64 bits in an int64 tensor: p, 1/N,
    shoup(1/N), floor(2^64/p), Garner inverses p_j^-1 mod p (j < 3) and their
    Shoup companions."""
    rows = []
    for i, p in enumerate(PRIMES[:nprimes]):
        ninv = pow(n, -1, p)
        ginv = [pow(PRIMES[j], -1, p) if j < i else 0 for j in range(3)]
        rows.append([p, ninv, shoup(ninv, p), (1 << 64) // p, *ginv, *(shoup(w, p) for w in ginv)])
    assert len(rows[0]) == _CONST_COLS
    return torch.tensor(rows, dtype=torch.int64, device=device)


def sweep_kernel(params, ctx: RingCtx, lib=None) -> dict:
    """The kernel of csrc/phase1_sweep.cu that serves this shape and how it
    is launched, as the source's own dispatcher (`sweep_plan`) says: its name
    with its template arguments as ptxas reports them (block keys, log2 N,
    l_gsw, primes, ell; zeros: run-time shapes), threads per CTA and dynamic
    shared memory.  `lib`: the library to ask (default: the built one)."""
    out = (ctypes.c_int * 7)()
    (lib or load_library()).mktfhe_phase1_sweep_describe(
        int(isinstance(params, KmsBlockParams)), _ell(params), ctx.nprimes, params.l_gsw,
        ctx.n.bit_length() - 1, out)
    return {
        "name": "phase1_sweep_kernel<" + ",".join(str(a) for a in out[:5]) + ">",
        "run_time_shapes": out[1] == 0,
        "threads": out[5],
        "shared_bytes": out[6],
    }


def _check(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0) -> None:
    """Refuse what the kernel does not take."""
    if not isinstance(params, (KmsParams, KmsBlockParams)):
        raise TypeError(f"the sweep takes KmsParams or KmsBlockParams, got {type(params).__name__}")
    n, npr, ell = ctx.n, ctx.nprimes, _ell(params)
    l, log_b = params.l_gsw, params.log_b_gsw
    if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0 and MIN_NPR <= npr <= MAX_NPR):
        raise ValueError(f"the sweep takes a power of two {MIN_N} <= N <= {MAX_N} and "
                         f"{MIN_NPR}-{MAX_NPR} primes, got N={n}, npr={npr}")
    if ctx.dtype != torch.int64:
        raise ValueError("the sweep works on the 2^64 torus")
    if not (1 <= l <= MAX_L_GSW and 1 <= log_b <= MAX_LOG_B and l * log_b <= 64):
        raise ValueError(f"the sweep takes l_gsw <= {MAX_L_GSW}, log_b_gsw <= {MAX_LOG_B} and "
                         f"l_gsw * log_b_gsw <= 64, got l_gsw={l}, log_b_gsw={log_b}")
    if not 1 <= ell <= MAX_PRODUCT_TERMS:
        raise ValueError(f"the sweep takes 1 <= ell <= {MAX_PRODUCT_TERMS}, got {ell}")
    if iter_rows < 1 or iter_rows > params.l_lev:
        raise ValueError(f"iter_rows must lie in 1..l_lev = {params.l_lev}, got {iter_rows}")
    if tildea_p.dtype != torch.int32:
        raise TypeError(f"tildea must be int32, got {tildea_p.dtype}")
    if tildea_p.dim() != 2 or tildea_p.shape[1] != params.n:
        raise ValueError(f"tildea must be [G, {params.n}], got {tuple(tildea_p.shape)}")
    if brk_hat_p.dtype != torch.int32:
        raise TypeError(f"brk_hat must be int32 residues, got {brk_hat_p.dtype}")
    if tuple(brk_hat_p.shape) != (params.n, 2, l, 2, npr, n):
        raise ValueError(f"brk_hat must be [{params.n}, 2, {l}, 2, {npr}, {n}], "
                         f"got {tuple(brk_hat_p.shape)}")
    tensors = {"tildea": tildea_p, "brk_hat": brk_hat_p}
    if isinstance(params, KmsBlockParams):
        if mono_hat.dtype != torch.int32:
            raise TypeError(f"mono_hat must be int32 residues, got {mono_hat.dtype}")
        if tuple(mono_hat.shape) != (2 * n, npr, n):
            raise ValueError(f"mono_hat must be [{2 * n}, {npr}, {n}], got {tuple(mono_hat.shape)}")
        tensors["mono_hat"] = mono_hat
    if acc0 is not None:
        if acc0.dtype != torch.int64:
            raise TypeError(f"acc0 must be int64, got {acc0.dtype}")
        if tuple(acc0.shape) != (tildea_p.shape[0], iter_rows, 2, n):
            raise ValueError(f"acc0 must be [{tildea_p.shape[0]}, {iter_rows}, 2, {n}], "
                             f"got {tuple(acc0.shape)}")
        tensors["acc0"] = acc0
    for name, t in tensors.items():
        if t.device != tildea_p.device:
            raise ValueError(f"{name} lies on {t.device}, tildea on {tildea_p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tildea_p.numel() > 0:
        lo, hi = torch.aminmax(tildea_p)
        if int(lo) < 0 or int(hi) >= 2 * n:
            raise ValueError(f"tildea must lie in [0, {2 * n}), got [{int(lo)}, {int(hi)}]")


def _launch(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0) -> torch.Tensor:
    n, npr, ell = ctx.n, ctx.nprimes, _ell(params)
    dev = tildea_p.device
    g = tildea_p.shape[0]
    ctas = g * iter_rows
    if ctas >= 1 << 31:
        raise ValueError(f"{ctas} (gate, row) pairs exceed the kernel's grid")
    # the kernel updates its accumulator in place: give it its own copy
    acc = phase1_init(iter_rows, params, ctx, g, dev) if acc0 is None else acc0.clone()
    if ctas == 0:
        return acc
    lib = load_library()
    tw_f, tw_f_sh, _ = _kernel_tables(n, npr, True, dev)
    tw_i, tw_i_sh, _ = _kernel_tables(n, npr, False, dev)
    consts = _sweep_consts(n, npr, dev)
    block = isinstance(params, KmsBlockParams)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mktfhe_phase1_sweep(
            acc.data_ptr(), tildea_p.data_ptr(), brk_hat_p.data_ptr(),
            mono_hat.data_ptr() if block else None,
            tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
            consts.data_ptr(), ctx.crt.prod_mod64, ctas, iter_rows, params.n // ell, ell, npr,
            params.l_gsw, params.log_b_gsw, n.bit_length() - 1, stream,
        )
    _build.check_launch(lib, err, "phase-1 sweep kernel")
    phase1_sweep.launches += 1
    return acc


def phase1_sweep(tildea_p, brk_hat_p, iter_rows: int, mono_hat, params, ctx: RingCtx,
                 acc0: torch.Tensor | None = None) -> torch.Tensor:
    """One party's phase-1 rotation -> torus accumulator [G, rows, 2, N]
    int64: the CUDA kernel on CUDA tensors (one launch), `phase1_sweep_plain`
    on CPU tensors.  Arguments as `phase1_sweep_plain`; tildea_p must be
    int32 and every tensor contiguous on one device."""
    _check(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)
    if tildea_p.device.type == "cpu":
        return phase1_sweep_plain(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)
    if tildea_p.device.type != "cuda":
        raise ValueError(f"no phase-1 sweep for device {tildea_p.device}")
    return _launch(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)


# kernel launches since the last reset (CPU calls run the plain version and do not count)
phase1_sweep.launches = 0


def reset_launches() -> None:
    phase1_sweep.launches = 0


def kms_phase1_mx3(tildea_p, brk_hat_p, iter_rows: int, mono_hat, params, ctx: RingCtx) -> torch.Tensor:
    """Phase 1 for one party: the sweep, then the lev key in the NTT domain,
    [G, rows, 2, npr, N] int32.  Bit-identical to kms.phase1 /
    kms.phase1_block."""
    acc = phase1_sweep(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx)
    return fwd_ntt_nat(lift(acc, ctx.crt), ctx.plan)


def bootstrap_mx3(ct: Lwe, scheme, params) -> Lwe:
    """KMS multi-key gate bootstrap with the sweep kernel in phase 1; phase 2
    and the key switch as in schemes.kms.  Serves KmsParams and
    KmsBlockParams; bit-identical to kms.bootstrap.  Party 1 sweeps one RLEV
    row (its phase 2 reads no other), the others l_lev."""
    from ..schemes import kms  # kms imports this module

    kms.require_brk(scheme, "bootstrap_mx3")
    ctx = kms._ctx(params)
    return kms.bootstrap_with_phase1(
        ct, scheme, params,
        lambda party, tildea_p, rows: kms_phase1_mx3(
            tildea_p, scheme.brk_hat[party], rows, scheme.mono_hat, params, ctx
        ),
    )
