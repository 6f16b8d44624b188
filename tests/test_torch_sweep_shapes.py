"""Which kernel serves which parameter set, and what the sweep wrappers refuse.

The two sweep kernels (csrc/phase1_sweep.cu, csrc/mx_sweep.cu) are compiled
for the shapes of the main paths and once more with run-time shapes for every
other shape their wrappers admit.  The choice is made in one place, the
sources' own dispatchers (`sweep_plan`, `mx_plan`), which the wrappers ask
through `fused_mx3.sweep_kernel` / `fused_mx2.mx_kernel`; here the dispatchers
are compiled for the host (tests/test_torch_kernels_host.py has the stand-in
for the CUDA header) and held against the table that PERF.md prints, for
every KMS preset, without a card.  The refusals need no compiler: their
tensors live on the meta device.
"""

import dataclasses

import pytest
import torch
from test_torch_kernels_host import MX_ENTRY, SWEEP_ENTRY, _host_library

from mktfhe_tpu_torch.kernels import fused_mx2, fused_mx3
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.schemes import kms, presets
from mktfhe_tpu_torch.schemes.params import CggiParams, KmsBlockParams, KmsParams

META = torch.device("meta")
MAX_SHARED = 232448  # bytes a CTA may ask for on sm_90

KMS_PRESETS = {
    name: p for name, p in vars(presets).items() if isinstance(p, (KmsParams, KmsBlockParams))
}
RUN_TIME = "phase1_sweep_kernel<0,0,0,0,1>"
RUN_TIME_BLOCK = "phase1_sweep_kernel<1,0,0,0,0>"
# preset -> the kernel of phase1_sweep.cu that serves it (PERF.md, section 6)
SWEEP_KERNEL = {
    "KMS_2PARTY": "phase1_sweep_kernel<0,11,3,4,1>",
    "KMS_4PARTY": "phase1_sweep_kernel<0,11,5,3,1>",
    "KMS_8PARTY": "phase1_sweep_kernel<0,11,4,3,1>",
    "KMS_16PARTY": "phase1_sweep_kernel<0,11,5,3,1>",
    "KMS_32PARTY": "phase1_sweep_kernel<0,11,6,3,1>",
    "KMS_2PARTY_BLOCK": "phase1_sweep_kernel<1,11,3,4,3>",
    "KMS_4PARTY_BLOCK": "phase1_sweep_kernel<1,11,5,3,3>",
    "KMS_8PARTY_BLOCK": "phase1_sweep_kernel<1,11,4,4,3>",
    "KMS_16PARTY_BLOCK": "phase1_sweep_kernel<1,11,5,3,3>",
    "KMS_32PARTY_BLOCK": "phase1_sweep_kernel<1,11,6,3,3>",
    "TINY_KMS_2PARTY": RUN_TIME,
    "TINY_KMS_2PARTY_MX": RUN_TIME,
}
# binary preset -> the kernel of mx_sweep.cu that serves its mx keys; every
# preset's power table fits in shared memory
MX_KERNEL = {
    "KMS_2PARTY": "mx_sweep_kernel<1,11,3,4>",
    "KMS_4PARTY": "mx_sweep_kernel<1,11,5,3>",
    "KMS_8PARTY": "mx_sweep_kernel<1,11,4,3>",
    "KMS_16PARTY": "mx_sweep_kernel<1,11,5,3>",
    "KMS_32PARTY": "mx_sweep_kernel<1,11,6,3>",
    "TINY_KMS_2PARTY_MX": "mx_sweep_kernel<1,0,0,0>",
}


@pytest.fixture(scope="module")
def sweep_lib(tmp_path_factory):
    return _host_library(fused_mx3.SOURCE, SWEEP_ENTRY, tmp_path_factory.mktemp("sweep_shapes"))


@pytest.fixture(scope="module")
def mx_lib(tmp_path_factory):
    return _host_library(fused_mx2.SOURCE, MX_ENTRY, tmp_path_factory.mktemp("mx_shapes"))


def test_tables_cover_every_preset():
    assert set(SWEEP_KERNEL) == set(KMS_PRESETS)
    binary = {n for n, p in KMS_PRESETS.items() if not isinstance(p, KmsBlockParams) and p.big_n >= 128}
    assert set(MX_KERNEL) == binary


def _sweep_args(params, ctx, rows=1):
    """Arguments of `phase1_sweep` without storage (no gates)."""
    n, npr = ctx.n, ctx.nprimes
    block = isinstance(params, KmsBlockParams)
    brk = torch.empty((params.n, 2, params.l_gsw, 2, npr, n), dtype=torch.int32, device=META)
    mono = torch.empty((2 * n, npr, n), dtype=torch.int32, device=META) if block else None
    ta = torch.empty((0, params.n), dtype=torch.int32, device=META)
    return ta, brk, rows, mono, params, ctx, None


def _mx_args(params, ctx_p, rows=1):
    brk = torch.empty((params.n, ctx_p.nprimes, 2 * params.l_gsw, 2, ctx_p.n), dtype=torch.int32, device=META)
    ta = torch.empty((0, params.n), dtype=torch.int32, device=META)
    return ta, brk, rows, params, ctx_p, None


@pytest.mark.parametrize("name", sorted(KMS_PRESETS))
def test_sweep_kernel_of_preset(sweep_lib, name):
    params = KMS_PRESETS[name]
    ctx = kms._ctx(params)
    fused_mx3._check(*_sweep_args(params, ctx, params.l_lev))  # admitted
    kernel = fused_mx3.sweep_kernel(params, ctx, sweep_lib)
    assert kernel["name"] == SWEEP_KERNEL[name]
    assert kernel["run_time_shapes"] == (kernel["name"] in (RUN_TIME, RUN_TIME_BLOCK))
    assert kernel["threads"] == min(ctx.n // 2, 512) and kernel["shared_bytes"] <= MAX_SHARED
    # accumulator, digit polynomials (at least four), residues, one prime's twiddles
    assert kernel["shared_bytes"] == ctx.n * (16 + 8 * max(params.l_gsw, 2) + 8 * ctx.nprimes + 16)
    if not kernel["run_time_shapes"]:
        block = isinstance(params, KmsBlockParams)
        shape = (int(block), ctx.n.bit_length() - 1, params.l_gsw, ctx.nprimes, params.ell if block else 1)
        assert kernel["name"] == "phase1_sweep_kernel<" + ",".join(map(str, shape)) + ">"


@pytest.mark.parametrize("name", sorted(MX_KERNEL))
def test_mx_kernel_of_preset(mx_lib, name):
    params = KMS_PRESETS[name]
    ctx_p = make_ring_ctx(params.big_n, params.ring_torus_bits, fused_mx2.mx_nprimes(params))
    fused_mx2._check(*_mx_args(params, ctx_p, params.l_lev))  # admitted
    kernel = fused_mx2.mx_kernel(params, ctx_p, mx_lib)
    assert kernel["name"] == MX_KERNEL[name]
    assert kernel["threads"] == min(ctx_p.n // 2, 512)
    assert kernel["table_in_shared"] and kernel["shared_bytes"] <= MAX_SHARED
    # the twiddles follow the table into shared memory where 16 N bytes are left:
    # at N = 2048 only beside KMS8party's four digits over three primes
    assert kernel["twiddles_in_shared"] == (name in ("KMS_8PARTY", "TINY_KMS_2PARTY_MX"))
    if not kernel["run_time_shapes"]:
        shape = (ctx_p.n.bit_length() - 1, params.l_gsw, ctx_p.nprimes)
        assert kernel["name"] == "mx_sweep_kernel<1," + ",".join(map(str, shape)) + ">"


def test_other_compiled_instances(sweep_lib, mx_lib):
    """The instances that no preset reaches: the small wide-gadget set of both
    kernels, and the six-digit gadget over four primes, whose power table does
    not fit in shared memory."""
    wide = dataclasses.replace(presets.TINY_KMS_2PARTY, big_n=256, log_b_gsw=12)
    ctx = make_ring_ctx(256, 64, 3)
    assert fused_mx3.sweep_kernel(wide, ctx, sweep_lib)["name"] == "phase1_sweep_kernel<0,8,3,3,1>"
    assert fused_mx2.mx_kernel(wide, ctx, mx_lib)["name"] == "mx_sweep_kernel<1,8,3,3>"
    six = fused_mx2.mx_kernel(presets.KMS_32PARTY, make_ring_ctx(2048, 64, 4), mx_lib)
    assert six["name"] == "mx_sweep_kernel<0,11,6,4>" and not six["table_in_shared"]
    assert six["twiddles_in_shared"] and six["shared_bytes"] == 2048 * (16 + 8 * 6 + 8 * 4 + 16)
    # KMS16party's gadget over four primes: no instance; the table no longer fits
    other = fused_mx2.mx_kernel(presets.KMS_16PARTY, make_ring_ctx(2048, 64, 4), mx_lib)
    assert other["name"] == "mx_sweep_kernel<0,0,0,0>" and other["twiddles_in_shared"]
    # two digits at N = 1024: no instance; table and twiddles in shared memory
    small = dataclasses.replace(presets.KMS_8PARTY, big_n=1024, l_gsw=2)
    assert fused_mx2.mx_kernel(small, make_ring_ctx(1024, 64, 3), mx_lib)["name"] == "mx_sweep_kernel<1,0,0,0>"
    # one more prime or digit than an instance's: run-time shapes
    assert fused_mx3.sweep_kernel(presets.KMS_8PARTY, make_ring_ctx(2048, 64, 4), sweep_lib)["name"] == RUN_TIME
    five = dataclasses.replace(presets.KMS_8PARTY_BLOCK, l_gsw=5, log_b_gsw=8)
    assert fused_mx3.sweep_kernel(five, make_ring_ctx(2048, 64, 4), sweep_lib)["name"] == RUN_TIME_BLOCK
    # another block size than the presets' ell = 3
    two = dataclasses.replace(presets.KMS_8PARTY_BLOCK, ell=2, d=304)
    assert fused_mx3.sweep_kernel(two, make_ring_ctx(2048, 64, 4), sweep_lib)["name"] == RUN_TIME_BLOCK


_BIN, _BLK = presets.KMS_8PARTY, presets.KMS_8PARTY_BLOCK
# (parameters, N of the context, primes, error, part of the message)
SWEEP_REFUSALS = {
    "n_4096": (dataclasses.replace(_BIN, big_n=4096), 4096, 3, ValueError, "a power of two 64 <= N <= 2048"),
    "n_32": (dataclasses.replace(_BIN, big_n=32), 32, 3, ValueError, "a power of two 64 <= N <= 2048"),
    "one_prime": (_BIN, 2048, 1, ValueError, "2-4 primes"),
    "seven_digits": (dataclasses.replace(_BIN, l_gsw=7, log_b_gsw=6), 2048, 3, ValueError, "l_gsw <= 6"),
    "log_b_17": (dataclasses.replace(_BIN, l_gsw=3, log_b_gsw=17), 2048, 3, ValueError, "log_b_gsw <= 16"),
    "over_64_digit_bits": (dataclasses.replace(_BIN, l_gsw=5, log_b_gsw=13), 2048, 3, ValueError,
                           "l_gsw * log_b_gsw <= 64"),
    "ell_17": (dataclasses.replace(_BLK, ell=17, d=1), 2048, 4, ValueError, "1 <= ell <= 16"),
    "cggi_params": (presets.CGGI_PARAM, 1024, 2, TypeError, "KmsParams or KmsBlockParams"),
}


@pytest.mark.parametrize("name", sorted(SWEEP_REFUSALS))
def test_sweep_refuses(name):
    params, n, npr, error, message = SWEEP_REFUSALS[name]
    ctx = make_ring_ctx(n, 64, npr)
    with pytest.raises(error, match=message.replace("*", r"\*")):
        fused_mx3._check(*_sweep_args(params, ctx))


MX_REFUSALS = {
    "block_keys": (_BLK, 2048, 4, TypeError, fused_mx2.BINARY_ONLY),
    "n_64": (dataclasses.replace(_BIN, big_n=64), 64, 3, ValueError, "a power of two 128 <= N <= 2048"),
    "n_4096": (dataclasses.replace(_BIN, big_n=4096), 4096, 3, ValueError, "a power of two 128 <= N <= 2048"),
    "five_primes_asked": (_BIN, 2048, 1, ValueError, "2-4 primes"),
    "seven_digits": (dataclasses.replace(_BIN, l_gsw=7, log_b_gsw=6), 2048, 3, ValueError, "l_gsw <= 6"),
    "context_of_another_n": (_BIN, 1024, 3, ValueError, "at N = 2048"),
    "cggi_params": (presets.CGGI_PARAM, 1024, 2, TypeError, "takes KmsParams"),
}


@pytest.mark.parametrize("name", sorted(MX_REFUSALS))
def test_mx_sweep_refuses(name):
    params, n, npr, error, message = MX_REFUSALS[name]
    ctx_p = make_ring_ctx(n, 64, npr)
    args = (None,) * 6 if isinstance(params, (KmsBlockParams, CggiParams)) else _mx_args(params, ctx_p)
    with pytest.raises(error, match=message):
        fused_mx2._check(args[0], args[1], 1, params, ctx_p, None)


def test_keys_of_another_prime_count_are_refused():
    """The mx keys carry their own prime count: a context over the scheme's
    primes does not fit keys built over the monomial's."""
    ctx_p = make_ring_ctx(2048, 64, 4)
    ta, brk, rows, params, _, _ = _mx_args(_BIN, make_ring_ctx(2048, 64, 3))
    with pytest.raises(ValueError, match="the context's primes are the key's"):
        fused_mx2._check(ta, brk, rows, params, ctx_p, None)
