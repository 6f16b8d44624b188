"""csrc/ntt.cu (B1 natural, B4 batch-minor), its device code run on the CPU.

The natural kernel's instance for every N the wrapper admits (64 .. 2048),
forward and inverse, on more tiles than CTAs (the CTAs go round the tiles and
the two buffers take turns) with a ragged last tile, against ring/ntt.py;
the batch-minor kernel on whole and ragged gate tiles.
The device code is compiled for the host with g++
(mktfhe_tpu_torch/tools/host_kernels.py: one std::thread per CUDA thread, a
std::barrier for `__syncthreads()`) and held bit for bit against the plain
PyTorch versions (tolerance 0).  It says nothing about what nvcc accepts or
about speed.  Skips where there is no g++ with C++20.
"""

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan
from mktfhe_tpu_torch.tools import host_kernels

CPU = torch.device("cpu")
CTAS = 2  # fewer than the tiles of every case below


@pytest.fixture(scope="module")
def ntt_lib(tmp_path_factory):
    try:
        return host_kernels.library("ntt", tmp_path_factory.mktemp("ntt_host"))
    except host_kernels.Unavailable as err:
        pytest.skip(str(err))


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_ntt_kernel_source_matches_plain(ntt_lib, n, npr):
    plan = make_plan(n, npr)
    rows = 2 * (2048 // n) + 3  # two whole tiles a prime and a ragged third
    rng = np.random.default_rng(n + npr)
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None]
    x = (rng.integers(0, 1 << 62, size=(rows, npr, n)) % p).astype(np.int32)
    x[0, :, :4] = (p - 1).astype(np.int32)  # the largest residues
    x = torch.from_numpy(x)
    for forward, plain in ((True, fwd_ntt), (False, inv_ntt)):
        kernel = kntt.nat_kernel(n, forward, ntt_lib)
        assert kernel["name"] == f"ntt_nat_kernel<{n.bit_length() - 1},{int(forward)}>"
        assert kernel["threads"] * 8 == kernel["polys_per_tile"] * n == 2048
        tw, tw_sh, consts = kntt._kernel_tables(n, npr, forward, CPU)
        out = torch.full_like(x, -1)
        err = ntt_lib.host_ntt_nat(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), consts.data_ptr(),
            x.numel() // n, npr, n.bit_length() - 1, int(forward), CTAS,
        )
        assert err == 0
        assert torch.equal(out, plain(x, plan)), f"{'fwd' if forward else 'inv'}: {int((out != plain(x, plan)).sum())} differ"


@pytest.mark.parametrize("gates", [5, 8, 19], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("n,npr", [(64, 2), (128, 3), (256, 4)])
def test_ntt_bm_kernel_source_matches_plain(ntt_lib, n, npr, gates):
    """The batch-minor load/store path: whole tiles of 8 gates and a ragged
    last one (5 = one short tile, 19 = two whole and one of 3)."""
    plan = make_plan(n, npr)
    rows = 3
    rng = np.random.default_rng(n + npr + gates)
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None, None, None]
    x = torch.from_numpy((rng.integers(0, 1 << 62, size=(npr, rows, n, gates)) % p).astype(np.int32))
    for forward in (True, False):
        tw, tw_sh, consts = kntt._kernel_tables(n, npr, forward, CPU)
        out = torch.full_like(x, -1)
        ntt_lib.host_ntt_bm(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), consts.data_ptr(),
            npr, rows, gates, n.bit_length() - 1, int(forward),
        )
        assert torch.equal(out, kntt.ntt_bm_plain(x, plan, forward))
