"""Port parity of `utils/serialization.py`.

Files written by the JAX package's `utils.save` load into the port's classes
equal, field by field and bit for bit, to `bridge.py`'s conversion of the
same objects (Shoup companions dropped, u32 / u64 as int32 / int64
carriers); the port's own save / load keeps every field; a bootstrap on keys
loaded from the JAX package's files equals the JAX bootstrap (CGGI TINY,
TinyKMS2party, LMSS, CCS).  Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mktfhe_tpu.kernels.batchminor import build_bm_kms_phase1 as j_build_bm
from mktfhe_tpu.kernels.fused_mx2 import build_mx_kms_keys as j_build_mx
from mktfhe_tpu.schemes import ccs as jccs
from mktfhe_tpu.schemes import cggi as jcggi
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes import lmss as jlmss
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt_ith
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu.utils import save as j_save
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.schemes import ccs, cggi, kms, lmss
from mktfhe_tpu_torch.utils import load, save

from test_ccs import TINY as CCS_TINY
from test_cggi import TINY as CGGI_TINY
from test_lmss import TINY as LMSS_TINY

CPU = torch.device("cpu")
MX = TEST_PRESETS["TinyKMS2partyMX"]


def _fields(obj):
    return obj._fields if hasattr(obj, "_fields") else [f.name for f in dataclasses.fields(obj)]


def _kms(params, seed):
    a = jkms.crs(jax.random.key(seed), params)
    parties = [jkms.party_keygen(jax.random.key(seed + 1 + i), a, params) for i in range(params.k)]
    return a, parties, jkms.setup(a, [p[3] for p in parties], params)


def _ccs():
    a = jccs.crs(jax.random.key(100), CCS_TINY)
    parties = [jccs.party_keygen(jax.random.key(200 + i), a, CCS_TINY) for i in range(CCS_TINY.k)]
    return a, parties, jccs.setup(a, [p[2] for p in parties], CCS_TINY)


@pytest.fixture(scope="module")
def objects():
    """name -> (the JAX package's object, bridge.py's conversion of it)."""
    a, parties, scheme = _kms(MX, 300)
    ca, cparties, cscheme = _ccs()
    cggi_scheme = jcggi.setup(jax.random.key(7), CGGI_TINY)[2]
    lmss_scheme = jlmss.setup(jax.random.key(11), LMSS_TINY)[2]
    m = jnp.array([True, False, True])
    ct = j_encrypt_ith(jax.random.key(1), m, 1, parties[1][0], MX.alpha, MX.k, (3,))
    mx_keys = j_build_mx([p[3] for p in parties], MX)
    bm_keys = j_build_bm([p[3] for p in parties], MX)
    port_ccs = ccs.setup(bridge.from_numpy(ca, CPU), [bridge.ccs_party_key(p[2], CPU) for p in cparties],
                         bridge.params(CCS_TINY))
    return {
        "CggiScheme": (cggi_scheme, bridge.cggi_scheme(cggi_scheme, CPU)),
        "LmssScheme": (lmss_scheme, bridge.lmss_scheme(lmss_scheme, CPU)),
        "KmsScheme": (scheme, bridge.kms_scheme(scheme, CPU)),
        "KmsScheme_without_brk": (jkms.drop_brk(scheme), bridge.kms_scheme(jkms.drop_brk(scheme), CPU)),
        "KmsPartyKey": (parties[0][3], bridge.party_key(parties[0][3], CPU)),
        "CcsPartyKey": (cparties[1][2], bridge.ccs_party_key(cparties[1][2], CPU)),
        "CcsScheme": (cscheme, port_ccs),
        "MxKmsKeys": (mx_keys, bridge.mx_kms_keys(mx_keys, CPU)),
        "BmKmsPhase1": (bm_keys, bridge.bm_kms_phase1(bm_keys, CPU)),
        "LweKey": (parties[1][0], bridge.lwe_key(parties[1][0], CPU)),
        "Lwe": (ct, bridge.lwe(ct, CPU)),
    }


NAMES = ["CggiScheme", "LmssScheme", "KmsScheme", "KmsScheme_without_brk", "KmsPartyKey", "CcsPartyKey",
         "CcsScheme", "MxKmsKeys", "BmKmsPhase1", "LweKey", "Lwe"]


def _assert_equal(got, want):
    assert type(got) is type(want)
    for name in _fields(want):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.device == w.device, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("name", NAMES)
def test_jax_file_loads_as_the_bridge_converts(objects, name, tmp_path):
    jobj, want = objects[name]
    path = str(tmp_path / "obj.npz")
    j_save(path, jobj)
    _assert_equal(load(path, "cpu"), want)


@pytest.mark.parametrize("name", NAMES)
def test_port_round_trip(objects, name, tmp_path):
    """The port's file holds the JAX layout (the JAX package's fields less
    the Shoup companions, unsigned where the JAX package stores unsigned)
    and loads back equal."""
    jobj, obj = objects[name]
    path = str(tmp_path / "obj.npz")
    save(path, obj)
    _assert_equal(load(path, "cpu"), obj)
    with np.load(path) as z:
        assert str(z["__module__"]) == type(obj).__module__
        stored = [k for k in z.files if not k.startswith("__")]
        assert stored == [f for f in _fields(jobj) if not f.endswith("_shoup")]
        for f in stored:
            assert z[f].dtype == np.asarray(getattr(jobj, f)).dtype, f


def test_load_refuses_what_it_cannot_build(objects, tmp_path, monkeypatch):
    path = str(tmp_path / "ct.npz")
    j_save(path, objects["Lwe"][0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load(path)  # the default device is the card
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, __module__=np.array("numpy"), __qualname__=np.array("ndarray"), x=np.zeros(1))
    with pytest.raises(ValueError, match="no class of"):
        load(bad, "cpu")
    short = str(tmp_path / "short.npz")
    np.savez(short, __module__=np.array("mktfhe_tpu.ciphertext.lwe"), __qualname__=np.array("Lwe"),
             b=np.zeros(1, np.uint32))
    with pytest.raises(ValueError, match="missing"):
        load(short, "cpu")


def _bootstrap_case(name):
    """(JAX bootstrap, port bootstrap, JAX scheme, JAX ct, port params)."""
    m1, m2 = np.array([True, False, True, False]), np.array([True, True, False, False])
    if name == "cggi":
        lwe_key, _, scheme = jcggi.setup(jax.random.key(7), CGGI_TINY)
        cts = [j_encrypt(jax.random.key(1 + i), jnp.array(m), lwe_key, CGGI_TINY.alpha, (4,)) for i, m in enumerate((m1, m2))]
        return jcggi.bootstrap, cggi.bootstrap, scheme, CGGI_TINY, cts
    if name == "lmss":
        lwe_key, _, scheme = jlmss.setup(jax.random.key(11), LMSS_TINY)
        cts = [j_encrypt(jax.random.key(1 + i), jnp.array(m), lwe_key, LMSS_TINY.alpha, (4,)) for i, m in enumerate((m1, m2))]
        return jlmss.bootstrap, lmss.bootstrap, scheme, LMSS_TINY, cts
    if name == "kms":
        params = TEST_PRESETS["TinyKMS2party"]
        _, parties, scheme = _kms(params, 400)
        boot = jkms.bootstrap
    else:
        params = CCS_TINY
        _, parties, scheme = _ccs()
        parties = [(p[0],) for p in parties]
        boot = jax.jit(jccs.bootstrap, static_argnames=("params", "pallas_ntt", "interpret"))
    cts = [j_encrypt_ith(jax.random.key(1 + i), jnp.array(m), i, parties[i][0], params.alpha, params.k, (4,))
           for i, m in enumerate((m1, m2))]
    return boot, kms.bootstrap if name == "kms" else ccs.bootstrap, scheme, params, cts


@pytest.mark.parametrize("name", ["cggi", "kms", "lmss", "ccs"])
def test_bootstrap_on_loaded_keys_matches_jax(name, tmp_path):
    j_boot, boot, jscheme, params, (ct1, ct2) = _bootstrap_case(name)
    ct = j_gate_affine(0, ct1, ct2)  # NAND
    want = j_boot(ct, jscheme, params)
    paths = [str(tmp_path / f) for f in ("scheme.npz", "ct.npz")]
    j_save(paths[0], jscheme)
    j_save(paths[1], ct)
    got = boot(load(paths[1], "cpu"), load(paths[0], "cpu"), bridge.params(params))
    np.testing.assert_array_equal(bridge.to_numpy(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(bridge.to_numpy(got.a), np.asarray(want.a))
