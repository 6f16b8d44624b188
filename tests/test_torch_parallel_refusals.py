"""The party-sharded bootstrap (parallel/) on a one-rank gloo group in this
process: a (1, 1) mesh gives `kms.bootstrap`'s bits, and the program
refuses keys and arguments that do not fit together before any collective.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.parallel.launch import bootstrap_jobs, run_ranks
from mktfhe_tpu_torch.parallel.mesh import PHASE2_FIELDS, make_mesh
from mktfhe_tpu_torch.parallel.shardmap import kms_bootstrap_shardmap
from mktfhe_tpu_torch.schemes import kms

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    """_TINY_PARAMS (k = 2), 4 gates, the JAX package's keys on the CPU."""
    ct, scheme = graft._make_inputs(graft._TINY_PARAMS, g=4)
    return bridge.lwe(ct, CPU), bridge.kms_scheme(scheme, CPU), bridge.params(graft._TINY_PARAMS)


@pytest.fixture
def mesh(tmp_path):
    """A (party 1, batch 1) mesh over a one-rank gloo group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        yield make_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shard_phase2", [False, True], ids=["replicated", "shard_phase2"])
def test_one_rank_equals_bootstrap(tiny, mesh, shard_phase2):
    ct, scheme, params = tiny
    want = kms.bootstrap(ct, scheme, params)
    got = kms_bootstrap_shardmap(ct, scheme, params, mesh, shard_phase2=shard_phase2)
    np.testing.assert_array_equal(bridge.to_numpy(got.b), bridge.to_numpy(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), bridge.to_numpy(want.a))


@pytest.mark.parametrize("field", PHASE2_FIELDS)
def test_cut_phase2_keys_need_shard_phase2(tiny, mesh, field):
    """A scheme whose phase-2 keys hold fewer than k parties (as
    shard_scheme(..., shard_phase2=True) leaves them) is refused by the
    replicated phase 2, which indexes them by global party."""
    ct, scheme, params = tiny
    cut = dataclasses.replace(scheme, **{field: getattr(scheme, field)[:1]})
    with pytest.raises(ValueError, match="shard_phase2=True"):
        kms_bootstrap_shardmap(ct, cut, params, mesh)


def test_unknown_phase1_keys_refused(tiny, mesh):
    ct, scheme, params = tiny
    with pytest.raises(TypeError, match="no phase-1 engine"):
        kms_bootstrap_shardmap(ct, scheme, params, mesh, phase1_keys=scheme)


@pytest.mark.parametrize("backend, device_type", [("mpi", "cpu"), ("gloo", "tpu")])
def test_run_ranks_refuses(backend, device_type):
    with pytest.raises(ValueError):
        run_ranks(bootstrap_jobs, 1, backend, ([],), device_type)
