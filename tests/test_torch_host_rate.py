"""csrc/butterfly_rate.cu, its device code run on the CPU.

The measuring kernel's lazy butterflies against the same butterflies on
Python integers.
The device code is compiled for the host with g++
(mktfhe_tpu_torch/tools/host_kernels.py: one std::thread per CUDA thread, a
std::barrier for `__syncthreads()`) and held bit for bit against the plain
PyTorch versions (tolerance 0).  It says nothing about what nvcc accepts or
about speed.  Skips where there is no g++ with C++20.
"""

import ctypes

import pytest
import torch

from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.tools import host_kernels

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rate_lib(tmp_path_factory):
    try:
        return host_kernels.library("butterfly_rate", tmp_path_factory.mktemp("rate_host"))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


@pytest.mark.parametrize("forward", [True, False], ids=["ct_lazy", "gs_lazy"])
def test_butterfly_rate_kernel_source_matches_big_integers(rate_lib, forward):
    """The measuring kernel's loop of lazy radix-8 butterflies stays inside
    their ranges: after several rounds the canonical residues are those of the
    same butterflies on Python integers mod p."""
    rounds, threads, seed = 5, 4, 7
    p = PRIMES[0]
    tw, tw_sh, _ = kntt._kernel_tables(64, 2, forward, CPU)
    out = torch.empty((threads, 8), dtype=torch.int32)
    rate_lib.host_butterfly_rate(out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), p, seed, rounds,
                                 int(forward), 1, threads)
    w = [int(v) & 0xFFFFFFFF for v in tw[0]]
    for gid in range(threads):
        e = [((seed + gid * 2654435761 % (1 << 32) + j * 40503) % (1 << 32)) % p for j in range(8)]
        for _ in range(rounds):
            for k in ((2, 1, 0) if forward else (0, 1, 2)):  # half-width 2^k, 2^(2-k) twiddles from entry 2^(2-k)
                for j in range(8):
                    if j & (1 << k):
                        continue
                    u, v, tww = e[j], e[j | (1 << k)], w[(1 << (2 - k)) + (j >> (k + 1))]
                    if forward:
                        e[j], e[j | (1 << k)] = (u + tww * v) % p, (u - tww * v) % p
                    else:
                        e[j], e[j | (1 << k)] = (u + v) % p, tww * (u - v) % p
        assert [int(v) & 0xFFFFFFFF for v in out[gid]] == e
