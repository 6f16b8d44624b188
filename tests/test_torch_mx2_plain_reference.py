"""The mx engine on the port's normal path against the benchmark's plain
reference, on the CPU.

`fused_mx2.setup` and the three-argument `bootstrap_mx2`, eagerly and
through `graphs.capture_bootstrap` (on the CPU the eager function behind the
graph's refusals), each under `gates.gate`, on keys that
`benchmark/reference/kms.py` (plain PyTorch; no JAX) makes from a seed, as
the benchmark's parties make theirs: every output word equals the
reference's bootstrap of the same gate inputs (tolerance 0: the bootstrap
is exact on the 2^64 torus), and every output decrypts to its clear gate.
At the tiny binary set of benchmark/tests/test_bench_reference.py (N = 128,
k = 2) and at KMS8party's gadget (l_gsw 4 / 9, l_lev 3 / 6, l_uni 8 / 4,
f 8 / log_d 2) with k = 3, n = 8, N = 128.  Also the set-up's and the
engine's refusals, and the named range around the mx image's build.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.adapters import kms_mx2 as ad  # noqa: E402
from benchmark.reference import kms_mx2 as ref  # noqa: E402
from mktfhe_tpu_torch import graphs  # noqa: E402
from mktfhe_tpu_torch.kernels import fused_mx2  # noqa: E402
from mktfhe_tpu_torch.schemes import kms  # noqa: E402
from mktfhe_tpu_torch.schemes.params import KmsBlockParams  # noqa: E402

SEED = 2**33 + 17
GATES = 12  # each of the six gates twice
BINARY = dict(n=8, alpha=16.0, f=8, log_d=2, big_n=128, beta=4.0, l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8,
              l_uni=3, log_b_uni=8, k=2)
KMS8_GADGET = dict(BINARY, l_gsw=4, log_b_gsw=9, l_lev=3, log_b_lev=6, l_uni=8, log_b_uni=4, f=8, log_d=2, k=3)
SETS = {"binary": BINARY, "kms8-gadget": KMS8_GADGET}


def _keys(p: dict) -> dict:
    """The reference's parameter set, CRS, secrets and party keys from the
    seed, and the port's scheme from its own set-up."""
    params = ref.KmsSet.from_config(p)
    port = ad.params({"name": "test", "params": p})
    dev = torch.device("cpu")
    ring = ref.ExactRing(params.big_n, dev)
    crs = ref.crs(params, SEED, dev)
    secrets = [ref.party_secrets(params, SEED, i, dev) for i in range(params.k)]
    keys = [ad.party_key(ref.party_keys(params, SEED, i, crs, ring)) for i in range(params.k)]
    return dict(params=params, port=port, ring=ring, crs=crs, secrets=secrets, keys=keys,
                scheme=ad.setup(crs, keys, port))


@pytest.fixture(scope="module", params=sorted(SETS))
def case(request) -> dict:
    c = _keys(SETS[request.param])
    params = c["params"]
    gen = ref.generator(torch.device("cpu"), SEED, "inputs")
    bits = ref.binary(gen, (2, GATES))
    party = torch.arange(2 * GATES).reshape(2, GATES) % params.k
    b, a = ref.encrypt_bits(gen, bits, party, c["secrets"], params.alpha)
    op = torch.arange(GATES) % len(ref.GATE_NAMES)
    c.update(bits=bits, op=op, ct1=ad.lwe(b[0], a[0]), ct2=ad.lwe(b[1], a[1]))
    bb, aa = ref.gate_affine(op, b[0], a[0], b[1], a[1])
    c["want"] = ref.bootstrap(c["ring"], params, bb, aa, SEED, c["crs"])
    return c


def test_setup_holds_the_mx_image_and_no_brk_hat(case):
    scheme, port = case["scheme"], case["port"]
    assert isinstance(scheme, fused_mx2.MxKmsScheme) and isinstance(scheme, kms.KmsScheme)
    assert scheme.brk_hat.numel() == 0
    npr = fused_mx2.mx_nprimes(port)
    assert tuple(scheme.brk_mx.shape) == (port.k, port.n, npr, 2 * port.l_gsw, 2, port.big_n)
    assert torch.equal(scheme.brk_mx, fused_mx2.build_mx_kms_keys(case["keys"], port).brk_mx)
    full = kms.setup(case["crs"], case["keys"], port)
    for name in ("crs_hat", "pub_b_hat", "rlk_d_hat", "rlk_f_hat", "ksk_b", "ksk_a", "mono_hat"):
        assert torch.equal(getattr(scheme, name), getattr(full, name)), name


@pytest.mark.parametrize("how", ["eager", "graphed"])
def test_gate_equals_the_plain_reference(case, how):
    """`gates.gate` over `bootstrap_mx2(ct, scheme, params)`, eager or
    through `capture_bootstrap`: every word of b and a equals the plain
    reference's, and every output decrypts to its clear gate."""
    scheme, port = case["scheme"], case["port"]
    boot = fused_mx2.bootstrap_mx2
    if how == "graphed":
        example = ad.affine(case["op"], case["ct1"], case["ct2"])
        boot = graphs.capture_bootstrap(fused_mx2.bootstrap_mx2, scheme, port, example)
    out = ad.gate(case["op"], case["ct1"], case["ct2"], lambda ct: boot(ct, scheme, port))
    rb, ra = case["want"]
    assert torch.equal(out.b, rb) and torch.equal(out.a, ra)
    clear = ref.clear_gate(case["op"], case["bits"][0], case["bits"][1])
    assert torch.equal(ref.decrypt(out.b, out.a, case["secrets"]), clear)


def test_bootstrap_mx2_equals_the_engines_on_brk_hat(case):
    """The same gate inputs through `kms.bootstrap` on a scheme with
    `brk_hat`: the same words."""
    ct = ad.affine(case["op"], case["ct1"], case["ct2"])
    want = kms.bootstrap(ct, kms.setup(case["crs"], case["keys"], case["port"]), case["port"])
    got = fused_mx2.bootstrap_mx2(ct, case["scheme"], case["port"])
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_setup_refuses_block_parameters():
    c = _keys(BINARY)
    block = KmsBlockParams(d=4, ell=2, **{k: v for k, v in BINARY.items() if k != "n"})
    with pytest.raises(TypeError, match="binary-key rotation"):
        fused_mx2.setup(c["crs"], c["keys"], block)


@pytest.mark.parametrize("how", ["kms.setup", "setup without brk_hat"])
def test_bootstrap_mx2_refuses_a_scheme_without_the_mx_image(how):
    c = _keys(BINARY)
    scheme = kms.setup(c["crs"], c["keys"], c["port"], with_brk=how == "kms.setup")
    ct = ad.lwe(torch.zeros(2, dtype=torch.int32), torch.zeros((2, c["port"].k * c["port"].n), dtype=torch.int32))
    with pytest.raises(ValueError, match="brk_mx"):
        fused_mx2.bootstrap_mx2(ct, scheme, c["port"])


def test_setup_opens_the_mx_keys_range():
    """The image's build runs inside the named range mktfhe/setup/mx_keys,
    once a set-up."""
    p = ref.KmsSet.from_config(BINARY)
    dev = torch.device("cpu")
    crs = ref.crs(p, SEED, dev)
    ring = ref.ExactRing(p.big_n, dev)
    keys = [ad.party_key(ref.party_keys(p, SEED, i, crs, ring)) for i in range(p.k)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fused_mx2.setup(crs, keys, ad.params({"name": "test", "params": BINARY}))
    names = [e.name for e in prof.events()]
    assert names.count("mktfhe/setup/mx_keys") == 1
