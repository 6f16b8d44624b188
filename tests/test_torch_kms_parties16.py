"""Port parity at k = 16 parties (the party count of KMS16party and
KMS16partyblock), with the tiny gadget of TinyKMS2partyMX at n = 8, N = 128.

The port's `kms.bootstrap`, `bootstrap_mx3`, `bootstrap_mx2` and
`kms.bootstrap_bm` (on CPU tensors their kernels' plain versions) on the JAX
package's keys and gate ciphertexts against the JAX `kms.bootstrap`,
tolerance 0: sixteen sequential merges of phase 2 and the key switch of
sixteen parties.  A file of its own:
the JAX compile of sixteen unrolled merges takes most of its time, and
`--dist loadfile` gives each file a worker.
"""

import pytest

from mktfhe_tpu.schemes.params import KmsParams
from mktfhe_tpu_torch.schemes import kms

from test_torch_kms_parties import TINY_NOISE, assert_same, port_output, reference_case

TINY_K16 = KmsParams(n=8, big_n=128, k=16, l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8,
                     **TINY_NOISE)


@pytest.fixture(scope="module")
def case():
    return reference_case(TINY_K16)


@pytest.mark.parametrize("engine", ["kms.bootstrap", "bootstrap_mx3", "bootstrap_mx2", "kms.bootstrap_bm"])
def test_bootstrap_matches_reference(case, engine):
    assert_same(port_output(case, engine), case["want"])


def test_phase2_in_chunks_matches_reference(case, monkeypatch):
    """Phase 2's hybrid product over chunks of five parties: merge 16 takes
    four chunks, the last of one party."""
    ctx = kms._ctx(case["tparams"])
    monkeypatch.setattr(kms, "PHASE2_CHUNK_RESIDUES", 5 * 4 * TINY_K16.l_uni * ctx.nprimes * ctx.n)
    assert kms.hybrid_chunk(4, case["tparams"], ctx) == 5
    assert_same(port_output(case, "bootstrap_mx2"), case["want"])
