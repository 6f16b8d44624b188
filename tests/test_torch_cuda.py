"""The CUDA NTT kernel against its plain twin, on the card (marker `cuda`).

Every supported ring size and prime count, forward and inverse, bit-exact
(tolerance 0), plus the wrapper's contract on CUDA tensors.  Skips where
there is no CUDA card; this file imports no jax, so on a machine without
it run it without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from mktfhe_tpu_torch.kernels import ntt as kntt
from mktfhe_tpu_torch.ring.modring import prime_column
from mktfhe_tpu_torch.ring.ntt import fwd_ntt, inv_ntt, make_plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NTT kernel has no CPU mode")
    return torch.device("cuda", 0)


def _residues(shape, npr, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 31, (*shape, npr, n), generator=gen, device=device)
    return torch.remainder(x, prime_column(npr, device)).to(torch.int32)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("npr", [2, 3, 4])
def test_kernel_matches_twin(device, n, npr):
    plan = make_plan(n, npr)
    x = _residues((3, 5), npr, n, device, seed=n + npr)
    kntt.reset_launches()
    hat = kntt.fwd_ntt_nat(x, plan)
    assert torch.equal(hat, fwd_ntt(x, plan))
    back = kntt.inv_ntt_nat(x, plan)
    assert torch.equal(back, inv_ntt(x, plan))
    assert torch.equal(kntt.inv_ntt_nat(hat, plan), x)
    assert (kntt.fwd_ntt_nat.launches, kntt.inv_ntt_nat.launches) == (1, 2)


def test_wrapper_contract_on_cuda(device):
    plan = make_plan(64, 2)
    x = _residues((4,), 2, 64, device, seed=0)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_nat(x.transpose(0, 1).contiguous().transpose(0, 1), plan)
    with pytest.raises(ValueError):
        kntt.fwd_ntt_nat(_residues((4,), 2, 32, device, seed=0), make_plan(32, 2))
    assert kntt.fwd_ntt_nat(x[:0], plan).shape == (0, 2, 64)
