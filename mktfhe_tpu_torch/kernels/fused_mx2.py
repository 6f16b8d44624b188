"""KMS phase-1 sweep on mx-domain keys and the bootstrap built on it.

Port of mktfhe_tpu/kernels/fused_mx2.py (`MxKmsKeys`, `build_mx_kms_keys`,
`make_mx_sweep_kernel`, `kms_phase1_mx2`, `bootstrap_mx2`): the engine that
carries its own image of the bootstrapping keys, in the mx evaluation order
(kernels/mx_ntt.py) and in a prime basis wide enough for the monomial
(X^a - 1) to be applied in the evaluation domain; one party's whole phase-1
rotation is ONE kernel launch (csrc/mx_sweep.cu) with the 2^64 RLEV
accumulator resident, then the lev key goes through the NTT kernel into the
scheme's own prime basis, then phase 2 and the key switch of schemes/kms.py.

The monomial.  mx position pos evaluates at psi^o with o odd
(`mx_ntt.mx_odd_exponents`), so the image of X^a - 1 there is
psi^(a o mod 2N) - 1.  The JAX package split that power into two factor rows
A[a, k1] * B[a, k2'] that it gathered per step for its TPU kernel
(`mono_factor_tables`); here kernel and plain version index ONE table of the
2N powers of psi per prime (`mx_power_table`) by a * o mod 2N.
tests/test_torch_mx2_keys.py holds it against the reference's `mx_mono_table`.

What the TPU kernel owed to its hardware has no counterpart: Shoup
companions of the keys (`brk_mx_shoup`), the u32 pairs and the mx
coefficient order of the accumulator, gate tiles, the bf16 digit split of
wide gadgets, and `build_mx_kms_keys`'s `chunk`, `store_shoup` and
`consume_brk`, which managed a 16 GB device.  The accumulator's edge is
[G, rows, 2, N] int64 in natural coefficient order.

On a CUDA tensor `mx_sweep` launches the kernel or raises; on a CPU tensor it
runs `mx_sweep_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ciphertext.gsw import rlwe_decomp_hat
from ..ciphertext.lwe import Lwe
from ..ring.context import RingCtx, make_ring_ctx, nprimes_monomial_weighted
from ..ring.modring import PRIMES, _root_of_unity, mulsum_mod, prime_column
from ..ring.ntt import fwd_ntt
from ..ring.torus import from_crt, lift
from ..schemes.params import KmsBlockParams, KmsParams
from . import _build
from .fused_mx3 import MAX_L_GSW, MAX_LOG_B, _sweep_consts, phase1_init
from .mx_ntt import NK, mx_eval_index, mx_fwd_ref, mx_inv_ref, mx_odd_exponents
from .ntt import MAX_N, MAX_NPR, MIN_NPR, _kernel_tables, fwd_ntt_nat

SOURCE = _build.CSRC / "mx_sweep.cu"
BINARY_ONLY = "the mx phase-1 kernel implements the binary-key rotation"


@dataclass(frozen=True)
class MxKmsKeys:
    """KMS phase-1 keys in the mx evaluation domain.

    brk_mx: [k, n, npr, 2*l_gsw, 2, N] int32 residues, npr = `mx_nprimes`."""

    brk_mx: torch.Tensor


def mx_nprimes(params: KmsParams) -> int:
    """CRT primes of the mx keys: the evaluation-domain monomial doubles the
    range of the 2*l_gsw-term external product (3 at KMS8party, 4 at
    KMS2party)."""
    return nprimes_monomial_weighted(
        params.ring_torus_bits, params.big_n, params.l_gsw, params.log_b_gsw)


def build_mx_kms_keys(party_keys, params: KmsParams, npr: int | None = None) -> MxKmsKeys:
    """Convert KMS party keys (torus domain, `KmsPartyKey.brk`
    [n, 2, l, 2, N]) for the mx engine, one party at a time: lift, forward
    transform into the mx order, then [n, 2, l, 2, npr, N] ->
    [n, npr, 2l, 2, N].  `npr` overrides the prime count."""
    from ..schemes import kms  # kms imports the kernels package

    npr = mx_nprimes(params) if npr is None else npr
    ctx = make_ring_ctx(params.big_n, params.ring_torus_bits, npr)
    return MxKmsKeys(brk_mx=kms.phase1_key_image(party_keys, ctx, mx_fwd_ref))


@functools.lru_cache(maxsize=None)
def mx_power_table(n: int, nprimes: int) -> np.ndarray:
    """pw [npr, 2N] uint32: pw[q, e] = psi_q^e mod p_q for the primitive 2N-th
    root psi_q of ring/ntt.py's plan."""
    rows = []
    for p in PRIMES[:nprimes]:
        psi = _root_of_unity(p, 2 * n)
        row, cur = [], 1
        for _ in range(2 * n):
            row.append(cur)
            cur = cur * psi % p
        rows.append(row)
    return np.array(rows, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _power_table_on(n: int, nprimes: int, device) -> torch.Tensor:
    """The power table as u32 bits in an int32 tensor on `device`."""
    return torch.from_numpy(mx_power_table(n, nprimes).view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _odd_exponents_on(n: int, device) -> torch.Tensor:
    return torch.from_numpy(mx_odd_exponents(n)).to(device)


def mx_mono_rows(a: torch.Tensor, n: int, nprimes: int) -> torch.Tensor:
    """Images of X^a - 1 in the mx evaluation order, from the power table:
    a [...] integer amounts in [0, 2N) -> int64 residues [..., npr, N],
    psi^(a o mod 2N) - 1 mod p at the position of odd exponent o."""
    dev = a.device
    expo = (a.long()[..., None] * _odd_exponents_on(n, dev)) % (2 * n)  # [..., N]
    pw = _power_table_on(n, nprimes, dev).long()  # [npr, 2N]
    rows = pw[:, expo].movedim(0, -2)  # [..., npr, N]
    return torch.remainder(rows - 1, prime_column(nprimes, dev))


def mx_sweep_plain(tildea_p, brk_mx_p, iter_rows: int, params: KmsParams, ctx_p: RingCtx,
                   acc0: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the sweep kernel.

    tildea_p: [G, n] rotation amounts in [0, 2N); brk_mx_p:
    [n, npr, 2l, 2, N] int32 (one party of `MxKmsKeys.brk_mx`); ctx_p: the
    ring context over the KEY's primes.  Returns the torus accumulator
    [G, rows, 2, N] int64 after all n steps, starting from `acc0` (default:
    the LEV gadget rows of `fused_mx3.phase1_init`).

    Per key bit: acc += INTT((psi^(a o) - 1) * sum_j brk[j] * NTT(digit_j(acc))),
    the sum and the monomial in the mx evaluation order.
    """
    g = tildea_p.shape[0]
    dev = tildea_p.device
    n, npr = ctx_p.n, ctx_p.nprimes
    p = prime_column(npr, dev)
    to_mx = mx_eval_index(n, dev)
    acc = phase1_init(iter_rows, params, ctx_p, g, dev) if acc0 is None else acc0
    for j in range(params.n):
        dhat = rlwe_decomp_hat(acc, params.l_gsw, params.log_b_gsw, ctx_p, fwd_ntt)[..., to_mx]
        x = dhat.reshape(g, iter_rows, 2 * params.l_gsw, 1, npr, n)
        ehat = mulsum_mod(x, brk_mx_p[j].permute(1, 2, 0, 3), 2, p)  # [G, rows, 2, npr, N]
        mono = mx_mono_rows(tildea_p[:, j], n, npr)[:, None, None]
        weighted = torch.remainder(ehat * mono, p).to(torch.int32)
        acc = acc + from_crt(mx_inv_ref(weighted, ctx_p.plan), ctx_p.crt, ctx_p.dtype)
    return acc


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mktfhe_mx_sweep.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_ulonglong, ctypes.c_longlong,
        i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.mktfhe_mx_sweep.restype = ctypes.c_int
    return lib


def mx_kernel(params: KmsParams, ctx_p: RingCtx, lib=None) -> dict:
    """The kernel of csrc/mx_sweep.cu that serves this shape and how it is
    launched, as the source's own dispatcher (`mx_plan`) says: its name with
    its template arguments as ptxas reports them (the power table in shared
    memory, log2 N, l_gsw, primes; zeros: run-time shapes), threads per CTA,
    dynamic shared memory (the state, then the power table if it fits, then
    one prime's twiddles if they fit).  `lib`: the library to ask (default:
    the built one)."""
    out = (ctypes.c_int * 7)()
    (lib or load_library()).mktfhe_mx_sweep_describe(
        ctx_p.nprimes, params.l_gsw, ctx_p.n.bit_length() - 1, out)
    return {
        "name": "mx_sweep_kernel<" + ",".join(str(a) for a in out[:4]) + ">",
        "run_time_shapes": out[1] == 0,
        "threads": out[4],
        "shared_bytes": out[5],
        "table_in_shared": bool(out[0]),
        "twiddles_in_shared": bool(out[6]),
    }


def _check(tildea_p, brk_mx_p, iter_rows, params, ctx_p, acc0) -> None:
    """Refuse what the kernel does not take."""
    if isinstance(params, KmsBlockParams):
        raise TypeError(BINARY_ONLY)
    if not isinstance(params, KmsParams):
        raise TypeError(f"the mx sweep takes KmsParams, got {type(params).__name__}")
    n, npr = ctx_p.n, ctx_p.nprimes
    l, log_b = params.l_gsw, params.log_b_gsw
    if not (NK <= n <= MAX_N and n & (n - 1) == 0 and MIN_NPR <= npr <= MAX_NPR):
        raise ValueError(f"the mx sweep takes a power of two {NK} <= N <= {MAX_N} and "
                         f"{MIN_NPR}-{MAX_NPR} primes, got N={n}, npr={npr}")
    if n != params.big_n or ctx_p.dtype != torch.int64:
        raise ValueError(f"the mx sweep works on the 2^64 torus at N = {params.big_n}, "
                         f"got a context of N={n}, {ctx_p.dtype}")
    if not (1 <= l <= MAX_L_GSW and 1 <= log_b <= MAX_LOG_B and l * log_b <= 64):
        raise ValueError(f"the mx sweep takes l_gsw <= {MAX_L_GSW}, log_b_gsw <= {MAX_LOG_B} and "
                         f"l_gsw * log_b_gsw <= 64, got l_gsw={l}, log_b_gsw={log_b}")
    if iter_rows < 1 or iter_rows > params.l_lev:
        raise ValueError(f"iter_rows must lie in 1..l_lev = {params.l_lev}, got {iter_rows}")
    if tildea_p.dtype != torch.int32:
        raise TypeError(f"tildea must be int32, got {tildea_p.dtype}")
    if tildea_p.dim() != 2 or tildea_p.shape[1] != params.n:
        raise ValueError(f"tildea must be [G, {params.n}], got {tuple(tildea_p.shape)}")
    if brk_mx_p.dtype != torch.int32:
        raise TypeError(f"brk_mx must be int32 residues, got {brk_mx_p.dtype}")
    if tuple(brk_mx_p.shape) != (params.n, npr, 2 * l, 2, n):
        raise ValueError(f"brk_mx must be [{params.n}, {npr}, {2 * l}, 2, {n}] (the context's "
                         f"primes are the key's), got {tuple(brk_mx_p.shape)}")
    tensors = {"tildea": tildea_p, "brk_mx": brk_mx_p}
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
    if tildea_p.numel() > 0:  # the amounts index the 2N powers of psi
        lo, hi = torch.aminmax(tildea_p)
        if int(lo) < 0 or int(hi) >= 2 * n:
            raise ValueError(f"tildea must lie in [0, {2 * n}), got [{int(lo)}, {int(hi)}]")


def _launch(tildea_p, brk_mx_p, iter_rows, params, ctx_p, acc0) -> torch.Tensor:
    n, npr = ctx_p.n, ctx_p.nprimes
    dev = tildea_p.device
    g = tildea_p.shape[0]
    ctas = g * iter_rows
    if ctas >= 1 << 31:
        raise ValueError(f"{ctas} (gate, row) pairs exceed the kernel's grid")
    # the kernel updates its accumulator in place: give it its own copy
    acc = phase1_init(iter_rows, params, ctx_p, g, dev) if acc0 is None else acc0.clone()
    if ctas == 0:
        return acc
    lib = load_library()
    tw_f, tw_f_sh, _ = _kernel_tables(n, npr, True, dev)
    tw_i, tw_i_sh, _ = _kernel_tables(n, npr, False, dev)
    consts = _sweep_consts(n, npr, dev)
    powers = _power_table_on(n, npr, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mktfhe_mx_sweep(
            acc.data_ptr(), tildea_p.data_ptr(), brk_mx_p.data_ptr(), powers.data_ptr(),
            tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
            consts.data_ptr(), ctx_p.crt.prod_mod64, ctas, iter_rows, params.n, npr,
            params.l_gsw, params.log_b_gsw, n.bit_length() - 1, stream,
        )
    _build.check_launch(lib, err, "mx sweep kernel")
    mx_sweep.launches += 1
    return acc


def mx_sweep(tildea_p, brk_mx_p, iter_rows: int, params: KmsParams, ctx_p: RingCtx,
             acc0: torch.Tensor | None = None) -> torch.Tensor:
    """One party's phase-1 rotation on mx-domain keys -> torus accumulator
    [G, rows, 2, N] int64: the CUDA kernel on CUDA tensors (one launch),
    `mx_sweep_plain` on CPU tensors.  Arguments as `mx_sweep_plain`; binary
    keys only; tildea_p must be int32 and every tensor contiguous on one
    device."""
    _check(tildea_p, brk_mx_p, iter_rows, params, ctx_p, acc0)
    if tildea_p.device.type == "cpu":
        return mx_sweep_plain(tildea_p, brk_mx_p, iter_rows, params, ctx_p, acc0)
    if tildea_p.device.type != "cuda":
        raise ValueError(f"no mx sweep for device {tildea_p.device}")
    return _launch(tildea_p, brk_mx_p, iter_rows, params, ctx_p, acc0)


# kernel launches since the last reset (CPU calls run the plain version and do not count)
mx_sweep.launches = 0


def reset_launches() -> None:
    mx_sweep.launches = 0


def kms_phase1_mx2(tildea_p, brk_mx_p, iter_rows: int, params: KmsParams, out_ctx: RingCtx) -> torch.Tensor:
    """Phase 1 for one party on mx-domain keys: the sweep over the key's
    primes (`brk_mx_p.shape[1]` of them), then the lev key in the NTT domain
    of the scheme's own prime basis `out_ctx`, [G, rows, 2, npr, N] int32.
    Bit-identical to kms.phase1."""
    ctx_p = make_ring_ctx(params.big_n, params.ring_torus_bits, brk_mx_p.shape[1])
    acc = mx_sweep(tildea_p, brk_mx_p, iter_rows, params, ctx_p)
    return fwd_ntt_nat(lift(acc, out_ctx.crt), out_ctx.plan)


def bootstrap_mx2(ct: Lwe, scheme, mx_keys: MxKmsKeys, params: KmsParams) -> Lwe:
    """KMS multi-key gate bootstrap with the mx sweep kernel in phase 1;
    phase 2 and the key switch as in schemes.kms.  Reads no `scheme.brk_hat`
    (a scheme after `kms.drop_brk` will do).  Binary keys only;
    bit-identical to kms.bootstrap and bootstrap_mx3.  Party 1 sweeps one
    RLEV row (its phase 2 reads no other), the others l_lev."""
    from ..schemes import kms  # kms imports the kernels package

    if isinstance(params, KmsBlockParams):
        raise TypeError(BINARY_ONLY)
    ctx = kms._ctx(params)
    return kms.bootstrap_with_phase1(
        ct, scheme, params,
        lambda party, tildea_p, rows: kms_phase1_mx2(tildea_p, mx_keys.brk_mx[party], rows, params, ctx),
    )
