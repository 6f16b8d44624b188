"""Port parity of the batch-minor NTT (mktfhe_tpu_torch/kernels/ntt.py).

`fwd_ntt_bm` / `inv_ntt_bm` of the port against the JAX package's Pallas
kernel `fwd_ntt_pallas` / `inv_ntt_pallas` run in interpret mode, on the
same numpy-seeded residues [npr, R, N, G]; tolerance 0.  On CPU tensors the
port's wrapper runs the kernel's plain version.  The Pallas kernel wants the
batch to be a multiple of its gate tile, so a batch of 5 or 8 is one tile;
the port's kernel has no such rule.
"""

import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels.ntt_pallas import fwd_ntt_pallas, inv_ntt_pallas
from mktfhe_tpu.ring.ntt import make_plan as j_make_plan
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.modring import PRIMES
from mktfhe_tpu_torch.ring.ntt import make_plan

CPU = torch.device("cpu")
NPR, ROWS = 2, 3


def _residues(n, g):
    rng = np.random.default_rng(n + g)
    p = np.array(PRIMES[:NPR], dtype=np.int64)[:, None, None, None]
    x = rng.integers(0, 1 << 62, size=(NPR, ROWS, n, g)) % p
    x[:, 0, :2, 0] = [[0, 0], [0, 0]]
    x[:, 0, 2, 0] = p[:, 0, 0, 0] - 1  # the largest residue of each prime
    return x.astype(np.uint32)


@pytest.mark.parametrize("g", [5, 8, 256], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("n", [64, 128], ids=lambda n: f"N{n}")
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_ntt_bm_matches_pallas_interpret(n, g, forward):
    x = _residues(n, g)
    jfn, fn = (fwd_ntt_pallas, kntt.fwd_ntt_bm) if forward else (inv_ntt_pallas, kntt.inv_ntt_bm)
    want = np.asarray(jfn(x, j_make_plan(n, NPR), g_tile=min(g, 128), interpret=True))
    kntt.reset_launches()
    got = fn(bridge.from_numpy(x, CPU), make_plan(n, NPR))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(bridge.to_numpy(got), want)
    assert kntt.fwd_ntt_bm.launches == 0 and kntt.inv_ntt_bm.launches == 0  # only kernel launches count


def test_ntt_bm_round_trip_and_refusals():
    plan = make_plan(64, NPR)
    x = bridge.from_numpy(_residues(64, 5), CPU)
    assert torch.equal(kntt.inv_ntt_bm(kntt.fwd_ntt_bm(x, plan), plan), x)
    with pytest.raises(TypeError):
        kntt.fwd_ntt_bm(x.long(), plan)
    with pytest.raises(ValueError):  # natural layout given to the batch-minor entry
        kntt.fwd_ntt_bm(x.permute(1, 3, 0, 2).contiguous(), plan)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_bm(x[0], plan)
    with pytest.raises(ValueError):
        kntt.inv_ntt_bm(x.transpose(1, 3).contiguous().transpose(1, 3), plan)
