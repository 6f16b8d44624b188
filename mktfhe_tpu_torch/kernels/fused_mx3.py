"""KMS phase-1 sweep and the bootstrap built on it.

Port of mktfhe_tpu/kernels/fused_mx3.py (`make_mx3_sweep_kernel`,
`kms_phase1_mx3`, `bootstrap_mx3`): every party's whole phase-1 blind
rotation as ONE kernel launch with the 2^64 RLEV accumulators resident over
all steps (csrc/phase1_sweep.cu; `kms_phase1_sweeps`, or one party's,
`phase1_sweep`), then each party's lev key through the NTT kernel
(`schemes/kms.py:levkey_lift`), then phase 2 and the key switch of
schemes/kms.py unchanged.

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

On CUDA tensors `phase1_sweep` and `phase1_sweeps` launch the kernel or
raise; on CPU tensors they run the plain version.
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
from ..ring.torus import from_crt, negacyclic_roll
from ..schemes.params import KmsBlockParams, KmsParams
from . import _build
from .ntt import MAX_N, MAX_NPR, MIN_N, MIN_NPR, _kernel_tables

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

    tildea_p: [G, n] integer rotation amounts, taken mod 2N (X^(a+2N) =
    X^a; the kernel reduces an int32 amount so too); brk_hat_p:
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
    ta = torch.remainder(tildea_p.long(), 2 * ctx.n).reshape(g, d, ell)
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
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
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


def _check(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0, parties=None) -> None:
    """Refuse what the kernel does not take: one party's tildea [G, n] and
    brk_hat [n, 2, l, 2, npr, N], or with `parties` every party's, tildea
    [G, parties * n] and brk_hat [parties, n, 2, l, 2, npr, N]."""
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
    lead = () if parties is None else (parties,)
    if parties is not None and parties < 1:
        raise ValueError(f"the sweeps take at least one party, got {parties}")
    if tildea_p.dim() != 2 or tildea_p.shape[1] != params.n * (parties or 1):
        raise ValueError(f"tildea must be [G, {params.n * (parties or 1)}], got {tuple(tildea_p.shape)}")
    if brk_hat_p.dtype != torch.int32:
        raise TypeError(f"brk_hat must be int32 residues, got {brk_hat_p.dtype}")
    if tuple(brk_hat_p.shape) != (*lead, params.n, 2, l, 2, npr, n):
        raise ValueError(f"brk_hat must be {[*lead, params.n, 2, l, 2, npr, n]}, "
                         f"got {list(brk_hat_p.shape)}")
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


def check_tildea_range(tildea: torch.Tensor, n: int) -> None:
    """Refuse rotation amounts outside [0, 2N): they index the 2N monomial
    images.  The check reads tildea's range back to the host, a sync that no
    CUDA graph can hold, so only the public wrappers make it; the bootstrap
    paths take tildea from `mod_switch_2n`, whose mask puts it in [0, 2N),
    and call the wrappers' private forms, which skip this read and nothing
    else."""
    if tildea.numel() > 0:
        lo, hi = torch.aminmax(tildea)
        if int(lo) < 0 or int(hi) >= 2 * n:
            raise ValueError(f"tildea must lie in [0, {2 * n}), got [{int(lo)}, {int(hi)}]")


def _launch(acc, tildea, brk_hat, parties, first_rows, rows, mono_hat, params, ctx) -> None:
    """One launch of the kernel over `parties` parties' sweeps, `acc`
    ([G (first_rows + (parties - 1) rows), 2, N], updated in place) party
    after party; the first party runs `first_rows` rows, the others `rows`."""
    n, npr, ell = ctx.n, ctx.nprimes, _ell(params)
    dev = tildea.device
    g = tildea.shape[0]
    ctas = acc.shape[0]
    if ctas >= 1 << 31:
        raise ValueError(f"{ctas} (party, gate, row) triples exceed the kernel's grid")
    if ctas == 0:
        return
    lib = load_library()
    tw_f, tw_f_sh, _ = _kernel_tables(n, npr, True, dev)
    tw_i, tw_i_sh, _ = _kernel_tables(n, npr, False, dev)
    consts = _sweep_consts(n, npr, dev)
    block = isinstance(params, KmsBlockParams)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mktfhe_phase1_sweep(
            acc.data_ptr(), tildea.data_ptr(), brk_hat.data_ptr(),
            mono_hat.data_ptr() if block else None,
            tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
            consts.data_ptr(), ctx.crt.prod_mod64, ctas, g, parties, first_rows, rows, params.n // ell,
            ell, npr, params.l_gsw, params.log_b_gsw, n.bit_length() - 1, stream,
        )
    _build.check_launch(lib, err, "phase-1 sweep kernel")
    phase1_sweep.launches += 1
    phase1_sweep.parties += parties


def phase1_sweep(tildea_p, brk_hat_p, iter_rows: int, mono_hat, params, ctx: RingCtx,
                 acc0: torch.Tensor | None = None) -> torch.Tensor:
    """One party's phase-1 rotation -> torus accumulator [G, rows, 2, N]
    int64: the CUDA kernel on CUDA tensors (one launch), `phase1_sweep_plain`
    on CPU tensors.  Arguments as `phase1_sweep_plain`; tildea_p must be
    int32 and every tensor contiguous on one device."""
    _check(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)
    check_tildea_range(tildea_p, ctx.n)
    return _run(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)


def _sweep(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0=None) -> torch.Tensor:
    """`phase1_sweep` for a tildea from `mod_switch_2n`: every check but the
    range read (`check_tildea_range`)."""
    _check(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)
    return _run(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)


def _run(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0) -> torch.Tensor:
    if tildea_p.device.type == "cpu":
        return phase1_sweep_plain(tildea_p, brk_hat_p, iter_rows, mono_hat, params, ctx, acc0)
    if tildea_p.device.type != "cuda":
        raise ValueError(f"no phase-1 sweep for device {tildea_p.device}")
    # the kernel updates its accumulator in place: give it its own copy
    g = tildea_p.shape[0]
    acc = phase1_init(iter_rows, params, ctx, g, tildea_p.device) if acc0 is None else acc0.clone()
    _launch(acc.view(g * iter_rows, 2, ctx.n), tildea_p, brk_hat_p, 1, iter_rows, iter_rows, mono_hat, params, ctx)
    return acc


def phase1_sweeps_init(g: int, parties: int, rows: int, params, ctx: RingCtx, device) -> torch.Tensor:
    """The accumulators of `parties` parties' sweeps as one buffer
    [G (1 + (parties - 1) rows), 2, N]: party 1's G one-row accumulators,
    then each later party's [G, rows], each from `phase1_init`."""
    acc = torch.empty((g * (1 + (parties - 1) * rows), 2, ctx.n), dtype=ctx.dtype, device=device)
    acc[:g].copy_(phase1_init(1, params, ctx, g, device).view(g, 2, ctx.n))
    acc[g:].view(parties - 1, g, rows, 2, ctx.n).copy_(phase1_init(rows, params, ctx, g, device))
    return acc


def _party_views(acc: torch.Tensor, g: int, parties: int, rows: int) -> list[torch.Tensor]:
    """Each party's accumulator [G, rows, 2, N] (party 1: one row) as a view
    of the buffer of `phase1_sweeps_init`."""
    n = acc.shape[-1]
    later = acc[g:].view(parties - 1, g, rows, 2, n)
    return [acc[:g].view(g, 1, 2, n), *later.unbind(0)]


def phase1_sweeps(tildea, brk_hat, l_lev: int, mono_hat, params, ctx: RingCtx) -> list[torch.Tensor]:
    """Every party's phase-1 rotation: tildea [G, k n] int32 (party i's
    amounts in columns [i n, (i + 1) n)), brk_hat [k, n, 2, l, 2, npr, N]
    (`KmsScheme.brk_hat`).  Party 1 sweeps one RLEV row, the others `l_lev`.
    Returns each party's torus accumulator [G, rows, 2, N] int64, views of
    one buffer (`phase1_sweeps_init`): on CUDA tensors ONE launch of the
    kernel over (party, gate, row), bit for bit k launches of
    `phase1_sweep`; on CPU tensors `phase1_sweep_plain` party by party."""
    _check(tildea, brk_hat, l_lev, mono_hat, params, ctx, None, parties=brk_hat.shape[0])
    check_tildea_range(tildea, ctx.n)
    return _run_sweeps(tildea, brk_hat, l_lev, mono_hat, params, ctx)


def kms_phase1_sweeps(tildea, brk_hat, l_lev: int, mono_hat, params, ctx: RingCtx) -> list[torch.Tensor]:
    """`phase1_sweeps` as a step of the bootstrap: tildea comes from
    `mod_switch_2n`, so its range is not read back (`check_tildea_range`);
    every other check is made."""
    _check(tildea, brk_hat, l_lev, mono_hat, params, ctx, None, parties=brk_hat.shape[0])
    return _run_sweeps(tildea, brk_hat, l_lev, mono_hat, params, ctx)


def _run_sweeps(tildea, brk_hat, rows, mono_hat, params, ctx) -> list[torch.Tensor]:
    dev = tildea.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no phase-1 sweep for device {dev}")
    g, parties = tildea.shape[0], brk_hat.shape[0]
    acc = phase1_sweeps_init(g, parties, rows, params, ctx, dev)
    views = _party_views(acc, g, parties, rows)
    if dev.type == "cuda":
        _launch(acc, tildea, brk_hat, parties, 1, rows, mono_hat, params, ctx)
        return views
    tild = tildea.reshape(g, parties, params.n)
    for party, view in enumerate(views):
        view.copy_(phase1_sweep_plain(tild[:, party], brk_hat[party], view.shape[1], mono_hat, params, ctx, view))
    return views


# kernel launches, and the party sweeps they served, since the last reset
# (CPU calls run the plain version and do not count)
phase1_sweep.launches = 0
phase1_sweep.parties = 0


def reset_launches() -> None:
    phase1_sweep.launches = 0
    phase1_sweep.parties = 0


def bootstrap_mx3(ct: Lwe, scheme, params) -> Lwe:
    """KMS multi-key gate bootstrap with the sweep kernel in phase 1; phase 2
    and the key switch as in schemes.kms.  Serves KmsParams and
    KmsBlockParams; bit-identical to kms.bootstrap.  Party 1 sweeps one RLEV
    row (its phase 2 reads no other), the others l_lev."""
    from ..schemes import kms  # kms imports this module

    kms.require_brk(scheme, "bootstrap_mx3")
    return kms.bootstrap_with_phase1(ct, scheme, params, "mx3")
