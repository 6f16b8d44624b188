"""Port parity of the party-sharded bootstrap (parallel/), replicated phase 2.

`kms_bootstrap_shardmap` in 4 gloo ranks on the CPU, a (party 2, batch 2)
mesh, on keys and ciphertexts the JAX package made and saved with its own
`utils.save` (the ranks load them with the port's `utils.load`), against the
JAX `kms.bootstrap` on the same keys and the port's single-process
`kms.bootstrap`; tolerance 0.  The ranks run the port's rank program
(`parallel.launch.bootstrap_jobs`) and report whether jax was imported there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mktfhe_tpu.kernels.batchminor import build_bm_kms_phase1 as j_build_bm
from mktfhe_tpu.kernels.fused_mx2 import build_mx_kms_keys as j_build_mx
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu.utils import save as j_save
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.parallel.launch import Job, bootstrap_jobs, run_ranks
from mktfhe_tpu_torch.schemes import kms

CPU = torch.device("cpu")


def run_jobs(world: int, jobs: list[Job]) -> list[list[dict]]:
    """The jobs in `world` gloo ranks on the CPU; per rank its results."""
    return run_ranks(bootstrap_jobs, world, "gloo", (jobs,), "cpu")


def assert_ranks_equal(ranks: list[list[dict]], index: int, want) -> None:
    """Every rank's output of job `index` equals `want` (a JAX Lwe), and no
    rank imported jax or the JAX package."""
    for rank, results in enumerate(ranks):
        res = results[index]
        np.testing.assert_array_equal(res["b"], np.asarray(want.b), err_msg=f"rank {rank} {res['name']}")
        np.testing.assert_array_equal(res["a"], np.asarray(want.a), err_msg=f"rank {rank} {res['name']}")
        assert not res["jax"] and not res["mktfhe_tpu"], f"rank {rank} imported jax"


def port_bootstrap(ct, scheme, params):
    """The port's single-process kms.bootstrap on the JAX package's keys."""
    got = kms.bootstrap(bridge.lwe(ct, CPU), bridge.kms_scheme(scheme, CPU), bridge.params(params))
    return bridge.to_numpy(got.b), bridge.to_numpy(got.a)


def save_all(tmp, **objs) -> dict:
    paths = {}
    for name, obj in objs.items():
        paths[name] = str(tmp / f"{name}.npz")
        j_save(paths[name], obj)
    return paths


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """_TINY_PARAMS (k = 2): 6 gates (3 a batch shard: no gate split over
    the party axis, the replicated phase 2) and 16 gates (4 a shard: split)."""
    params = graft._TINY_PARAMS
    ct6, scheme = graft._make_inputs(params, g=6)
    ct16, _ = graft._make_inputs(params, g=16)
    paths = save_all(tmp_path_factory.mktemp("tiny"), scheme=scheme, ct6=ct6, ct16=ct16)
    tparams = bridge.params(params)
    jobs = [Job(f"g{g}", tparams, paths["scheme"], paths[f"ct{g}"], mesh=(2, 2)) for g in (6, 16)]
    ranks = run_jobs(4, jobs)
    return {"params": params, "scheme": scheme, "cts": {6: ct6, 16: ct16}, "ranks": ranks}


@pytest.mark.parametrize("g", [6, 16], ids=["replicated_phase2", "gate_split"])
def test_shardmap_matches_single_device(tiny, g):
    ct, scheme, params = tiny["cts"][g], tiny["scheme"], tiny["params"]
    want = jkms.bootstrap(ct, scheme, params)
    assert_ranks_equal(tiny["ranks"], [6, 16].index(g), want)
    b, a = port_bootstrap(ct, scheme, params)
    np.testing.assert_array_equal(b, np.asarray(want.b))
    np.testing.assert_array_equal(a, np.asarray(want.a))


def test_shardmap_mx2_and_bm_engines(tmp_path):
    """The mx2 and batch-minor phase-1 engines in the ranks, on the JAX
    package's MxKmsKeys and BmKmsPhase1 (Shoup companions dropped on load),
    TinyKMS2partyMX, 16 gates on the (2, 2) mesh."""
    params = TEST_PRESETS["TinyKMS2partyMX"]
    a = jkms.crs(jax.random.key(0), params)
    parties = [jkms.party_keygen(jax.random.key(1 + i), a, params) for i in range(params.k)]
    scheme = jkms.setup(a, [p[3] for p in parties], params)
    m = jnp.asarray(np.random.default_rng(5).integers(0, 2, 16).astype(bool))
    ct = j_gate_affine(
        0,
        j_encrypt(jax.random.key(91), m, 0, parties[0][0], params.alpha, params.k, (16,)),
        j_encrypt(jax.random.key(92), ~m, 1, parties[1][0], params.alpha, params.k, (16,)),
    )
    paths = save_all(tmp_path, scheme=jkms.drop_brk(scheme), ct=ct,
                     mx=j_build_mx([p[3] for p in parties], params),
                     bm=j_build_bm([p[3] for p in parties], params))
    tparams = bridge.params(params)
    jobs = [Job(e, tparams, paths["scheme"], paths["ct"], mesh=(2, 2), phase1_keys=paths[e]) for e in ("mx", "bm")]
    ranks = run_jobs(4, jobs)
    want = jkms.bootstrap(ct, scheme, params)
    for index in range(len(jobs)):
        assert_ranks_equal(ranks, index, want)
    b, a = port_bootstrap(ct, scheme, params)
    np.testing.assert_array_equal(b, np.asarray(want.b))
    np.testing.assert_array_equal(a, np.asarray(want.a))
