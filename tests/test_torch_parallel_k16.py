"""Port parity of the party-sharded bootstrap (parallel/) at k = 16 parties,
with phase-2 keys party-sharded (`shard_phase2`), in 4 gloo ranks on the
CPU, mesh (party 4, batch 1): 4 parties a rank.

The keys and gate ciphertexts of tests/test_torch_kms_parties16.py's case
(the JAX package's, bridged; the port's scheme, mx and batch-minor keys
built from them), saved with the port's `utils.save`.  The batch-minor
engine's job reads one file a rank holding only that rank's share
(`mesh.party_share`); the mx2 engine's job reads the whole files and cuts
its share (`shard_scheme`).  Every rank's output must equal the JAX
`kms.bootstrap`, tolerance 0; every rank must hold only its share, and the
first job's ranks must have read only their share and the ciphertext.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.kernels import batchminor, fused_mx2
from mktfhe_tpu_torch.parallel.launch import Job, _bytes
from mktfhe_tpu_torch.parallel.mesh import party_share
from mktfhe_tpu_torch.schemes import kms
from mktfhe_tpu_torch.schemes.presets import TINY_KMS_2PARTY
from mktfhe_tpu_torch.utils import save

from test_torch_kms_parties import reference_case
from test_torch_kms_parties16 import TINY_K16
from test_torch_parallel import assert_ranks_equal, run_jobs

WORLD = 4
# two parties a share, at a width where keygen takes no time
SMALL = dataclasses.replace(TINY_KMS_2PARTY, n=2, big_n=64, k=2 * WORLD)


@pytest.fixture(scope="module")
def k16(tmp_path_factory):
    case = reference_case(TINY_K16)
    tparams = case["tparams"]
    lean = kms.drop_brk(case["scheme"])
    objs = {"scheme": lean, "ct": case["ct"],
            "mx": fused_mx2.build_mx_kms_keys(case["party_keys"], tparams),
            "bm": batchminor.build_bm_kms_phase1(case["party_keys"], tparams)}
    tmp = tmp_path_factory.mktemp("k16")
    paths = {name: str(tmp / f"{name}.npz") for name in objs}
    for name, obj in objs.items():
        save(paths[name], obj)
    shares = {name: [party_share(objs[name], p, WORLD, shard_phase2=name == "scheme") for p in range(WORLD)]
              for name in ("scheme", "bm")}
    share_paths = {name: tuple(str(tmp / f"{name}_{p}.npz") for p in range(WORLD)) for name in shares}
    for name, parts in shares.items():
        for path, part in zip(share_paths[name], parts):
            save(path, part)
    jobs = [
        Job("bm shares", tparams, share_paths["scheme"], paths["ct"], mesh=(WORLD, 1),
            phase1_keys=share_paths["bm"], shard_phase2=True),
        Job("mx2 whole files", tparams, paths["scheme"], paths["ct"], mesh=(WORLD, 1), phase1_keys=paths["mx"],
            shard_phase2=True),
    ]
    return {"case": case, "objs": objs, "shares": shares, "ranks": run_jobs(WORLD, jobs)}


@pytest.mark.parametrize("index", [0, 1], ids=["bm_shard_phase2", "mx2_shard_phase2"])
def test_k16_sharded_matches_reference(k16, index):
    assert_ranks_equal(k16["ranks"], index, k16["case"]["want"])


def test_rank_holds_and_reads_only_its_share(k16):
    """A rank of the share files' job reads from disk only its share of the
    scheme and of the batch-minor keys, and the ciphertext; a rank of the
    whole files' job reads them whole and keeps its share; either way it
    holds a quarter of the party-sharded keys."""
    objs, shares = k16["objs"], k16["shares"]
    ct = _bytes(objs["ct"])
    for rank, (bm, mx) in enumerate(k16["ranks"]):
        share = _bytes(shares["scheme"][rank]) + _bytes(shares["bm"][rank])
        assert bm["key_bytes"] == share < _bytes(objs["scheme"]) + _bytes(objs["bm"])
        assert bm["loaded_bytes"] == share + ct
        whole = _bytes(objs["scheme"]) + _bytes(objs["mx"])
        assert mx["key_bytes"] == _bytes(shares["scheme"][rank]) + _bytes(objs["mx"]) // WORLD
        assert mx["loaded_bytes"] == whole + ct
        assert bm["host_rss_bytes"] > 0 and bm["device_peak_bytes"] == 0


def test_party_share_cuts_the_party_axis():
    """The WORLD shares of a scheme concatenate to the whole along the party
    axis (the phase-2 keys too with shard_phase2), the other fields stay
    whole, and a party count the axis does not divide is refused."""
    gen = torch.Generator().manual_seed(3)
    params = SMALL
    a = kms.crs(gen, params)
    scheme = kms.setup(a, [kms.party_keygen(gen, a, params)[3] for _ in range(params.k)], params)
    parts = [party_share(scheme, p, WORLD, shard_phase2=True) for p in range(WORLD)]
    for f in dataclasses.fields(scheme):
        whole = getattr(scheme, f.name)
        if f.name in ("crs_hat", "mono_hat"):
            assert all(getattr(part, f.name) is whole for part in parts)
        else:
            np.testing.assert_array_equal(torch.cat([getattr(part, f.name) for part in parts]).numpy(),
                                          whole.numpy(), err_msg=f.name)
    assert party_share(scheme, 1, WORLD).pub_b_hat is scheme.pub_b_hat
    with pytest.raises(ValueError):
        party_share(scheme, 0, 3)

