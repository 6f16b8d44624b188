"""Port parity of the party-sharded bootstrap (parallel/): party-sharded
phase-2 keys, a party-only mesh, and `kms_bootstrap_sharded`.

Gloo ranks on the CPU run the port's rank program on keys and ciphertexts
the JAX package made and saved; every rank's output must equal the JAX
`kms.bootstrap` on the same keys and the port's single-process
`kms.bootstrap`; tolerance 0.
"""

import numpy as np
import pytest

import __graft_entry__ as graft
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.parallel.launch import Job

from test_torch_parallel import assert_ranks_equal, port_bootstrap, run_jobs, save_all


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of 4 ranks: _TINY8_PARAMS (k = 8) with shard_phase2 on a
    (party 4, batch 1) mesh, 2 parties a rank, and on a (2, 2) mesh, 4
    parties a rank (the party axis' ranks are not the world's);
    `kms_bootstrap_sharded` at _TINY_PARAMS on a (2, 2) mesh."""
    tmp = tmp_path_factory.mktemp("p2")
    ct8, scheme8 = graft._make_inputs(graft._TINY8_PARAMS, g=8)
    ct4, scheme4 = graft._make_inputs(graft._TINY_PARAMS, g=4)
    paths = save_all(tmp, scheme8=scheme8, ct8=ct8, scheme4=scheme4, ct4=ct4)
    jobs = [
        Job("shard_phase2", bridge.params(graft._TINY8_PARAMS), paths["scheme8"], paths["ct8"], mesh=(4, 1),
            shard_phase2=True),
        Job("sharded", bridge.params(graft._TINY_PARAMS), paths["scheme4"], paths["ct4"], mesh=(2, 2), sharded=True),
        Job("shard_phase2_2x2", bridge.params(graft._TINY8_PARAMS), paths["scheme8"], paths["ct8"], mesh=(2, 2),
            shard_phase2=True),
    ]
    cases = [(ct8, scheme8, graft._TINY8_PARAMS), (ct4, scheme4, graft._TINY_PARAMS)]
    return {"ranks": run_jobs(4, jobs), "cases": cases}


@pytest.mark.parametrize("jobs", [(0, 2), (1,)], ids=["shard_phase2", "kms_bootstrap_sharded"])
def test_four_ranks(four_ranks, jobs):
    ct, scheme, params = four_ranks["cases"][jobs[0]]
    want = jkms.bootstrap(ct, scheme, params)
    for index in jobs:
        assert_ranks_equal(four_ranks["ranks"], index, want)
    b, a = port_bootstrap(ct, scheme, params)
    np.testing.assert_array_equal(b, np.asarray(want.b))
    np.testing.assert_array_equal(a, np.asarray(want.a))


def test_party_only_mesh(tmp_path):
    """A mesh with a party axis and no batch axis, 2 ranks, 4 gates (split
    2 a rank in phase 2)."""
    params = graft._TINY_PARAMS
    ct, scheme = graft._make_inputs(params, g=4)
    paths = save_all(tmp_path, scheme=scheme, ct=ct)
    ranks = run_jobs(2, [Job("party_only", bridge.params(params), paths["scheme"], paths["ct"], mesh=(2, None))])
    assert_ranks_equal(ranks, 0, jkms.bootstrap(ct, scheme, params))
