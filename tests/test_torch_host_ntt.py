"""csrc/ntt.cu (B1 natural, B4 batch-minor), its device code run on the CPU.

The natural kernel's instance for every N the wrapper admits (64 .. 2048),
forward and inverse, on more tiles than CTAs (the CTAs go round the tiles and
the two buffers take turns) with a ragged last tile, against ring/ntt.py;
the batch-minor kernel's instances the same way (the CTAs of a cluster at
once), on whole and ragged gate tiles, at N = 64 .. 512 and at the full
N = 2048, with each tile width its dispatcher picks, against `ntt_bm_plain`.
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


def _bm_case(ntt_lib, n, npr, rows, gates, clusters=CTAS):
    """The batch-minor kernel that the source's dispatcher picks for [npr,
    rows, N, gates], run on `clusters` clusters of CTAs both ways against the
    plain version; returns the two instances."""
    plan = make_plan(n, npr)
    rng = np.random.default_rng(n + npr + rows + gates)
    p = np.array(PRIMES[:npr], dtype=np.int64)[:, None, None, None]
    x = (rng.integers(0, 1 << 62, size=(npr, rows, n, gates)) % p).astype(np.int32)
    x[:, 0, :4, -1] = (p[:, 0, 0] - 1).astype(np.int32)  # the largest residues, in the last column
    x = torch.from_numpy(x)
    kernels = []
    for forward in (True, False):
        kernel = kntt.bm_kernel(n, npr, rows, gates, forward, ntt_lib)
        assert kernel["tiles"] > clusters  # the clusters go round the tiles, both buffers take turns
        tw, tw_sh, consts = kntt._kernel_tables(n, npr, forward, CPU)
        out = torch.full_like(x, -1)
        err = ntt_lib.host_ntt_bm(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), consts.data_ptr(),
            npr, rows, gates, n.bit_length() - 1, int(forward), clusters,
        )
        assert err == 0
        want = kntt.ntt_bm_plain(x, plan, forward)
        assert torch.equal(out, want), f"{kernel['name']}: {int((out != want).sum())} differ"
        kernels.append(kernel)
    return kernels


@pytest.mark.parametrize("gates", [5, 8, 19], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("n,npr", [(64, 2), (128, 3), (256, 4)])
def test_ntt_bm_kernel_source_matches_plain(ntt_lib, n, npr, gates):
    """The batch-minor load/store path: whole tiles and a ragged last one
    (5 = one whole tile of 4 and one of 1, 19 = four whole and one of 3),
    rows not 16-byte aligned (5, 19: word-by-word copies) and aligned (8)."""
    fwd, inv = _bm_case(ntt_lib, n, npr, 3, gates)
    assert fwd["name"] == f"ntt_bm_kernel<{n.bit_length() - 1},4,0,1>" and inv["name"].endswith(",4,0,0>")
    assert fwd["cluster"] == 1  # too few tiles for clusters: each CTA stores its own


def test_ntt_bm_kernel_source_full_n(ntt_lib):
    """N = 2048 (the KMS engine's), 3 primes, a ragged batch of 13 gates
    (rows not 16-byte aligned, CTAs of the cluster with no gate or one):
    tiles of 4 gates, two clusters of 8 CTAs going round 36 line tiles."""
    fwd, _ = _bm_case(ntt_lib, 2048, 3, 12, 13)
    assert fwd["name"] == "ntt_bm_kernel<11,4,1,1>" and (fwd["tiles"], fwd["cluster"]) == (3 * 12, 8)


# N <= 512, one shape for each tile width and cluster the dispatcher picks:
# 8 gates a tile (clusters of 4) where a shape has enough line tiles of 32
# gates for 4 CTAs each to fill the card twice over, else 4 (clusters of 8),
# and no cluster where 8 CTAs a line tile would not fill it twice over
@pytest.mark.parametrize("n,npr,rows,gates,gt,cluster", [
    (64, 2, 132, 8, 8, 4), (256, 3, 44, 13, 8, 4), (128, 2, 20, 32, 4, 8), (512, 2, 3, 24, 4, 1),
], ids=["N64_gt8", "N256_gt8_ragged", "N128_gt4", "N512_gt4_no_cluster"])
def test_ntt_bm_kernel_source_tile_widths(ntt_lib, n, npr, rows, gates, gt, cluster):
    fwd, inv = _bm_case(ntt_lib, n, npr, rows, gates)
    assert fwd["gates_per_tile"] == inv["gates_per_tile"] == gt and fwd["cluster"] == inv["cluster"] == cluster
