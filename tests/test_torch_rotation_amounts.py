"""Rotation amounts outside [0, 2N): X^(a + 2N) = X^a in Z_q[X]/(X^N + 1).

The public kernel wrappers refuse such amounts, but the bootstrap steps
(`kms_phase1_sweeps`, `kms_phase1_mx2`, `bootstrap_fused`) do not read them
back, so every kernel and its plain twin must give the ring's answer for any
int32 amount: the twin of the phase-1 sweep (block and binary keys), the
twin of the CGGI step and `fused_mx2.mx_mono_rows` at amounts 2N, 2N + 5,
4N - 1, -1, -2N and near both int32 ends each equal themselves at the
amount mod 2N; the device code of the block sweep and of the CGGI step,
compiled for the host (tools/host_kernels.py), equals the twin there.
Inside [0, 2N) each twin still equals the JAX package's function (tolerance
0).  Outside it the JAX package's gathers clamp, which is not the ring's
answer, so the port is held to its own twin there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels import fused_mx2 as jmx2
from mktfhe_tpu.ring.context import make_ring_ctx as j_ring_ctx
from mktfhe_tpu.schemes import cggi as jcggi
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.params import CggiParams as JCggiParams
from mktfhe_tpu.schemes.params import KmsBlockParams as JKmsBlockParams
from mktfhe_tpu.schemes.params import KmsParams as JKmsParams
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import batchminor, fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.params import KmsBlockParams, KmsParams
from mktfhe_tpu_torch.tools import host_kernels

from test_torch_host_sweep import _host_sweep

CPU = torch.device("cpu")
G = 3
_KMS = dict(alpha=16.0, f=8, log_d=2, beta=4.0, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2)
BINARY = KmsParams(n=9, big_n=64, l_gsw=3, log_b_gsw=8, **_KMS)
BLOCK = KmsBlockParams(d=3, ell=3, big_n=64, l_gsw=3, log_b_gsw=8, **_KMS)
J_CGGI = JCggiParams(n=9, alpha=16.0, f=8, log_d=2, big_n=64, k=1, beta=16.0, l_gsw=3, log_b_gsw=8)
CGGI = bridge.params(J_CGGI)


def outside(n: int) -> list[int]:
    """int32 amounts outside [0, 2N): 2N, 2N + 5, 4N - 1, -1, -2N and
    -2^31 + 7, -2^31, 2^31 - 1, 2^31 - 5 (both ends of int32)."""
    return [2 * n, 2 * n + 5, 4 * n - 1, -1, -2 * n, -(1 << 31) + 7, -(1 << 31), (1 << 31) - 1, (1 << 31) - 5]


def amounts(n: int, steps: int, seed: int) -> torch.Tensor:
    """[G, steps] int32: every amount of `outside(n)` once, the rest random
    over all of int32."""
    rng = np.random.default_rng(seed)
    ta = rng.integers(-(1 << 31), 1 << 31, size=(G, steps), dtype=np.int64)
    odd = outside(n)
    ta.reshape(-1)[: len(odd)] = odd
    return torch.from_numpy(ta.astype(np.int32))


def reduced(ta: torch.Tensor, n: int) -> torch.Tensor:
    return torch.remainder(ta.long(), 2 * n).to(torch.int32)


def _residues(rng, shape, npr: int, prime_axis: int) -> torch.Tensor:
    p = np.array(PRIMES[:npr], dtype=np.int64).reshape([-1 if i == prime_axis else 1 for i in range(len(shape))])
    return torch.from_numpy((rng.integers(0, 1 << 62, size=shape) % p).astype(np.int32))


def sweep_case(params, npr: int = 3, rows: int = 2, seed: int = 1) -> dict:
    """Random keys and accumulators for one party's sweep at `params`, with
    amounts outside [0, 2N)."""
    ctx = make_ring_ctx(params.big_n, 64, npr)
    rng = np.random.default_rng(seed)
    brk = _residues(rng, (params.n, 2, params.l_gsw, 2, npr, ctx.n), npr, 4)
    mono = kms.monomial_table(ctx, CPU) if isinstance(params, KmsBlockParams) else None
    acc0 = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=(G, rows, 2, ctx.n), dtype=np.int64))
    return dict(params=params, ctx=ctx, brk=brk, mono=mono, rows=rows, acc0=acc0, ta=amounts(ctx.n, params.n, seed))


def step_case(seed: int = 2) -> dict:
    ctx = make_ring_ctx(CGGI.big_n, 32, 2)
    rng = np.random.default_rng(seed)
    brk = _residues(rng, (CGGI.n, ctx.nprimes, 2 * CGGI.l_gsw, 2, ctx.n), ctx.nprimes, 1)
    acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(G, 2, ctx.n), dtype=np.int64).astype(np.int32))
    return dict(ctx=ctx, brk=brk, mono=kms.monomial_table(ctx, CPU), acc=acc, ta=amounts(ctx.n, CGGI.n, seed))


def plain_sweep(case: dict, ta: torch.Tensor) -> torch.Tensor:
    return fused_mx3.phase1_sweep_plain(ta, case["brk"], case["rows"], case["mono"], case["params"], case["ctx"],
                                        case["acc0"])


def plain_steps(case: dict, ta: torch.Tensor) -> torch.Tensor:
    acc = case["acc"]
    for i in range(CGGI.n):
        acc = fused_step.cggi_step_plain(acc, case["brk"][i], ta[:, i], case["mono"], CGGI, case["ctx"])
    return acc


@pytest.mark.parametrize("params", [BINARY, BLOCK], ids=["binary", "block"])
def test_sweep_twin_takes_amounts_mod_2n(params):
    case = sweep_case(params)
    want = plain_sweep(case, reduced(case["ta"], case["ctx"].n))
    assert torch.equal(plain_sweep(case, case["ta"]), want)


def test_step_twin_takes_amounts_mod_2n():
    case = step_case()
    assert torch.equal(plain_steps(case, case["ta"]), plain_steps(case, reduced(case["ta"], case["ctx"].n)))


@pytest.mark.parametrize("n, npr", [(128, 3), (256, 4)])
def test_mx_mono_rows_take_amounts_mod_2n(n, npr):
    a = torch.tensor(outside(n), dtype=torch.int32)
    assert torch.equal(fused_mx2.mx_mono_rows(a, n, npr), fused_mx2.mx_mono_rows(reduced(a, n), n, npr))


# --- inside [0, 2N): the JAX package's functions ----------------------------


def _reference_scheme(params):
    """The JAX package's KMS scheme at `params` (seeds of test_torch_mx3.py)
    and the port's from the same keys."""
    a = jkms.crs(jax.random.key(300), params)
    parties = [jkms.party_keygen(jax.random.key(400 + i), a, params) for i in range(params.k)]
    tparams = bridge.params(params)
    port = kms.setup(bridge.from_numpy(a, CPU), [bridge.party_key(p[3], CPU) for p in parties], tparams)
    return jkms.setup(a, [p[3] for p in parties], params), port, tparams


J_BINARY = JKmsParams(n=4, big_n=64, l_gsw=3, log_b_gsw=8, **_KMS)
J_BLOCK = JKmsBlockParams(d=2, ell=3, big_n=64, l_gsw=3, log_b_gsw=8, **_KMS)


@pytest.mark.parametrize("params", [J_BINARY, J_BLOCK], ids=["binary", "block"])
def test_sweep_twin_equals_jax_inside(params):
    """The twin's lev key (after `kms.levkey_lift`) == kms.phase1 /
    kms.phase1_block of the JAX package, amounts over all of [0, 2N)."""
    js, port, tparams = _reference_scheme(params)
    ctx = j_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    rows = params.l_lev
    rng = np.random.default_rng(7)
    ta = rng.integers(0, 2 * params.big_n, size=(G, params.n)).astype(np.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * params.big_n - 1
    if isinstance(params, JKmsBlockParams):
        want = jax.jit(lambda t: jkms.phase1_block(t, js.brk_hat[1], js.brk_shoup[1], rows, js, params, ctx))(ta)
    else:
        want = jax.jit(lambda t: jkms.phase1(t, js.brk_hat[1], js.brk_shoup[1], rows, params, ctx))(ta)
    tctx = kms._ctx(tparams)
    acc = fused_mx3.phase1_sweep_plain(torch.from_numpy(ta), port.brk_hat[1], rows, port.mono_hat, tparams, tctx)
    np.testing.assert_array_equal(bridge.to_numpy(kms.levkey_lift(acc, tctx)), np.asarray(want))


def test_step_twin_equals_jax_inside():
    """All n steps of the twin from random accumulators == the JAX package's
    `cggi.blind_rotate`, on its keys, amounts over all of [0, 2N)."""
    _, _, js = jcggi.setup(jax.random.key(7), J_CGGI)
    bm = batchminor.convert_scheme(bridge.cggi_scheme(js, CPU), CGGI)
    ctx = jcggi._ctx(J_CGGI)
    rng = np.random.default_rng(8)
    ta = rng.integers(0, 2 * CGGI.big_n, size=(G, CGGI.n)).astype(np.int32)
    ta[0, 0], ta[-1, -1] = 0, 2 * CGGI.big_n - 1
    acc = rng.integers(0, 1 << 32, size=(G, 2, CGGI.big_n), dtype=np.uint64).astype(np.uint32)
    want = jax.jit(lambda a, t: jcggi.blind_rotate(a, t, js, J_CGGI, ctx))(jnp.asarray(acc), jnp.asarray(ta))
    got = bridge.from_numpy(acc, CPU)
    tctx = fused_step._ctx(CGGI)
    for i in range(CGGI.n):
        got = fused_step.cggi_step_plain(got, bm.brk_bm[i], torch.from_numpy(ta[:, i]), bm.mono_hat, CGGI, tctx)
    np.testing.assert_array_equal(bridge.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n, npr", [(128, 3), (256, 3)])
def test_mx_mono_rows_equal_jax_inside(n, npr):
    want, _ = jmx2.mx_mono_table(j_ring_ctx(n, 64, npr))
    np.testing.assert_array_equal(fused_mx2.mx_mono_rows(torch.arange(2 * n), n, npr).numpy(), np.asarray(want))


# --- the kernels' device code, compiled for the host -------------------------


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    try:
        return {name: host_kernels.library(name, tmp_path_factory.mktemp(name))
                for name in ("phase1_sweep", "cggi_step")}
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


@pytest.mark.parametrize("params", [BINARY, BLOCK], ids=["binary", "block"])
def test_sweep_kernel_source_reduces_amounts(host_libs, params):
    """The block sweep indexes its 2N monomial images with the amount
    reduced on its bits, the binary sweep rolls by it: both == the twin at
    the amounts mod 2N, through the compiled instance and run-time shapes."""
    case = sweep_case(params)
    want = plain_sweep(case, reduced(case["ta"], case["ctx"].n))
    for run_time_shapes in (False, True):
        got = _host_sweep(host_libs["phase1_sweep"], case["ta"], case["brk"], case["rows"], case["mono"],
                          params, case["ctx"], case["acc0"], run_time_shapes)
        assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"


def test_step_kernel_source_reduces_amounts(host_libs):
    case = step_case()
    ctx, n = case["ctx"], case["ctx"].n
    want = plain_steps(case, reduced(case["ta"], n))
    tw_f, tw_f_sh, _ = kntt._kernel_tables(n, ctx.nprimes, True, CPU)
    tw_i, tw_i_sh, _ = kntt._kernel_tables(n, ctx.nprimes, False, CPU)
    consts = fused_mx3._sweep_consts(n, ctx.nprimes, CPU)
    fused_step._check(case["acc"], case["ta"], case["brk"], case["mono"], CGGI, ctx, 0, CGGI.n)
    for run_time_shapes in (False, True):
        got = case["acc"].clone()
        err = host_libs["cggi_step"].host_cggi_step(
            got.data_ptr(), case["ta"].data_ptr(), case["brk"].data_ptr(), case["mono"].data_ptr(),
            tw_f.data_ptr(), tw_f_sh.data_ptr(), tw_i.data_ptr(), tw_i_sh.data_ptr(),
            consts.data_ptr(), ctx.crt.prod_mod32, G, CGGI.n, 0, CGGI.n, ctx.nprimes, CGGI.l_gsw,
            CGGI.log_b_gsw, n.bit_length() - 1, int(run_time_shapes),
        )
        assert err == 0
        assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"
