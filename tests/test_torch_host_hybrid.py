"""csrc/hybrid_product.cu, its device code run on the CPU.

The hybrid product of a KMS merge through the template instances of the
KMS presets' shapes and through the kernel with run-time shapes, at merges
of 1 (the crs alone), 2 and 5 components, against the plain version
`kms._hybrid_product` (tolerance 0).  The device code is compiled for the
host with g++ (mktfhe_tpu_torch/tools/host_kernels.py: one std::thread per
CUDA thread, a std::barrier for `__syncthreads()`).  It says nothing about
what nvcc accepts or about speed.  Skips where there is no g++ with C++20.
Also the wrapper on CPU tensors: the plain version, no launch, and its
refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import fused_mx3, hybrid_product
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.context import make_ring_ctx
from mktfhe_tpu_torch.ring.modring import PRIMES, prime_column
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.presets import TEST_PRESETS

CPU = torch.device("cpu")
BASE = TEST_PRESETS["TinyKMS2party"]
# (l_uni, log_b_uni, primes, N): the KMS presets' shapes, which have an
# instance, and shapes the kernel with run-time shapes serves
SHAPES = {
    "kms8partyblock": (8, 4, 4, 2048),
    "kms32partyblock": (16, 2, 3, 2048),
    "kms2party": (3, 10, 4, 2048),
    "run_time_n64": (3, 8, 3, 64),
    "run_time_64_digit_bits": (4, 16, 2, 256),
    "run_time_n1024": (5, 7, 3, 1024),
}
INSTANCE = {
    "kms8partyblock": "hybrid_product_kernel<11,8,4>",
    "kms32partyblock": "hybrid_product_kernel<11,16,3>",
    "kms2party": "hybrid_product_kernel<11,3,4>",
}
GATES = 2


@pytest.fixture(scope="module")
def hybrid_lib(tmp_path_factory):
    from mktfhe_tpu_torch.tools import host_kernels

    try:
        return host_kernels.library("hybrid_product", tmp_path_factory.mktemp("hybrid_host"))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


def _case(name: str, p1: int, g: int = GATES):
    """Parameters, ring and uniform inputs: y over all 64 bits (with the
    extremes), keys as residues."""
    l, log_b, npr, n = SHAPES[name]
    params = dataclasses.replace(BASE, l_uni=l, log_b_uni=log_b, big_n=n)
    ctx = make_ring_ctx(n, 64, npr)
    rng = np.random.default_rng(1000 * p1 + len(name))
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]

    def residues(*lead):
        return torch.from_numpy((rng.integers(0, 1 << 62, size=(*lead, npr, n)) % p).astype(np.int32))

    y = rng.integers(-(1 << 63), (1 << 63) - 1, size=(g, p1, n), dtype=np.int64)
    y[0, 0, :6] = [-1, -(1 << 63), (1 << 63) - 1, 0, 1, 1 << 31]
    return params, ctx, (torch.from_numpy(y), residues(l), residues(p1 - 1, l), residues(l))


def _host(lib, y, rd, pub, crs, params, ctx, run_time_shapes=False):
    """The wrapper's launch (hybrid_product._launch), on the host library."""
    hybrid_product._check(y, rd, pub, crs, params, ctx)
    n, npr = ctx.n, ctx.nprimes
    g, p1 = y.shape[:2]
    u = torch.full((g, p1, npr, n), -1, dtype=torch.int32)
    v = torch.full((g, npr, n), -1, dtype=torch.int32)
    tw_f, tw_f_sh, _ = kntt._kernel_tables(n, npr, True, CPU)
    consts = fused_mx3._sweep_consts(n, npr, CPU)
    err = lib.host_hybrid_product(
        y.data_ptr(), rd.data_ptr(), pub.data_ptr(), crs.data_ptr(), u.data_ptr(), v.data_ptr(),
        tw_f.data_ptr(), tw_f_sh.data_ptr(), consts.data_ptr(), g, p1, npr, params.l_uni, params.log_b_uni,
        n.bit_length() - 1, int(run_time_shapes),
    )
    assert err == 0
    return u, v


@pytest.mark.parametrize("p1", [1, 2, 5])
@pytest.mark.parametrize("name", list(SHAPES))
def test_hybrid_kernel_source_matches_plain(hybrid_lib, name, p1):
    params, ctx, (y, rd, pub, crs) = _case(name, p1)
    want_u, want_v = kms._hybrid_product(y, rd, pub, crs, params, ctx, prime_column(ctx.nprimes, CPU))
    kernel = hybrid_product.hybrid_kernel(params, ctx, hybrid_lib)
    assert kernel["name"] == INSTANCE.get(name, "hybrid_product_kernel<0,0,0>")
    assert kernel["run_time_shapes"] == (name not in INSTANCE)
    paths = [False, True] if name in INSTANCE else [False]  # an instance's shape through both kernels
    for run_time_shapes in paths:
        u, v = _host(hybrid_lib, y, rd, pub, crs, params, ctx, run_time_shapes)
        assert torch.equal(u.long(), want_u), f"u: {int((u.long() != want_u).sum())} of {u.numel()} differ"
        assert torch.equal(v.long(), want_v), f"v: {int((v.long() != want_v).sum())} of {v.numel()} differ"


def test_wrapper_on_cpu_runs_plain_version():
    params, ctx, (y, rd, pub, crs) = _case("run_time_n64", 3)
    hybrid_product.reset_launches()
    u, v = hybrid_product.hybrid_product(y, rd, pub, crs, params, ctx)
    want_u, want_v = kms._hybrid_product(y, rd, pub, crs, params, ctx, prime_column(ctx.nprimes, CPU))
    assert torch.equal(u, want_u) and torch.equal(v, want_v)
    assert hybrid_product.hybrid_product.launches == 0  # only kernel launches count


REFUSALS = {
    "y_int32": (lambda y, rd, pub, crs: (y.int(), rd, pub, crs), TypeError),
    "y_two_dims": (lambda y, rd, pub, crs: (y[:, 0], rd, pub, crs), ValueError),
    "y_no_components": (lambda y, rd, pub, crs: (y[:, :0], rd, pub[:0], crs), ValueError),
    "y_strided": (lambda y, rd, pub, crs: (y.transpose(0, 1).contiguous().transpose(0, 1), rd, pub, crs), ValueError),
    "rd_int64": (lambda y, rd, pub, crs: (y, rd.long(), pub, crs), TypeError),
    "rd_shape": (lambda y, rd, pub, crs: (y, rd[:-1], pub, crs), ValueError),
    "pub_one_short": (lambda y, rd, pub, crs: (y, rd, pub[:-1], crs), ValueError),
    "pub_strided": (lambda y, rd, pub, crs: (y, rd, pub.transpose(0, 1).contiguous().transpose(0, 1), crs),
                    ValueError),
    "crs_primes": (lambda y, rd, pub, crs: (y, rd, pub, crs[:, :-1]), ValueError),
    "crs_strided": (lambda y, rd, pub, crs: (y, rd, pub, crs.transpose(0, 1).contiguous().transpose(0, 1)),
                    ValueError),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_wrapper_refuses(name):
    params, ctx, args = _case("run_time_n64", 3)
    change, err = REFUSALS[name]
    with pytest.raises(err):
        hybrid_product.hybrid_product(*change(*args), params, ctx)


@pytest.mark.parametrize("bad", [dict(l_uni=17, log_b_uni=2), dict(l_uni=2, log_b_uni=33), dict(l_uni=5, log_b_uni=13)])
def test_wrapper_refuses_gadgets_it_cannot_sum(bad):
    params, ctx, args = _case("run_time_n64", 2)
    with pytest.raises(ValueError):
        hybrid_product.hybrid_product(*args, dataclasses.replace(params, **bad), ctx)
