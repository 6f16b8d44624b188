"""The bootstraps as CUDA graphs (mktfhe_tpu_torch/graphs.py), on the CPU.

A CUDA graph holds no host read, so no bootstrap may make one.  Here:
`mod_switch_2n` puts every rotation amount in [0, 2N) (why the bootstrap
paths may skip the kernel wrappers' read of tildea's range); every engine's
bootstrap runs at tiny sets with the tensor methods that read a value back
to the host patched to raise (a stand-in, on the CPU, for the card's sync
check), and a second time with the constructors that copy host data into a
tensor patched to raise too (the constant tables are made once and cached:
a graph could not hold the copy); and `capture_bootstrap` on a CPU
ciphertext calls the eager function, bit for bit (tolerance 0), behind the
refusals the graph makes on the card.  The keys come from the port's own
keygens (the eager engines are held to the JAX package elsewhere); the
messages from numpy.  The graphs themselves: tests/test_torch_cuda.py,
marker `cuda`.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from mktfhe_tpu_torch.ciphertext.lwe import Lwe
from mktfhe_tpu_torch.graphs import capture_bootstrap
from mktfhe_tpu_torch.kernels import batchminor, fused_mx2, fused_mx3, fused_step
from mktfhe_tpu_torch.ring.torus import bits_of
from mktfhe_tpu_torch.schemes import ccs, cggi, gates, kms, lmss
from mktfhe_tpu_torch.schemes.common import mod_switch_2n
from mktfhe_tpu_torch.schemes.params import BlockParams, CcsParams, KmsBlockParams
from mktfhe_tpu_torch.schemes.presets import TEST_PRESETS

CPU = torch.device("cpu")
BATCH = 5
# the tiny sets of tests/test_lmss.py, tests/test_ccs.py and tests/test_kms.py
LMSS_TINY = BlockParams(d=8, ell=2, alpha=16.0, f=8, log_d=2, big_n=64, k=1, beta=16.0, l_gsw=3, log_b_gsw=8)
CCS_TINY = CcsParams(n=8, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0, l_uni=3, log_b_uni=8, k=2)
KMS_TINY_BLOCK = KmsBlockParams(
    d=4, ell=2, alpha=16.0, f=8, log_d=2, big_n=64, beta=4.0,
    l_gsw=3, log_b_gsw=8, l_lev=2, log_b_lev=8, l_uni=3, log_b_uni=8, k=2,
)


def _messages(seed: int):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 2, BATCH).astype(bool)) for _ in range(2))


def _single_key(params, setup, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    lwe_key, _, scheme = setup(gen, params)
    m1, m2 = (m.to(device) for m in _messages(seed))
    ct1, ct2 = (gates.lwe_encrypt_bit(gen, m, lwe_key, params.alpha, (BATCH,)) for m in (m1, m2))
    return scheme, gates.gate_affine(gates.GATE_IDS["NAND"], ct1, ct2), ct2, lambda out: gates.lwe_decrypt_bit(out, lwe_key)


def _multi_key(mod, params, device, seed, setup=None):
    """Keys of `mod`'s keygen and the scheme of its set-up (or of `setup`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = mod.crs(gen, params)
    parties = [mod.party_keygen(gen, a, params) for _ in range(params.k)]
    keys = [p[0] for p in parties]
    m1, m2 = (m.to(device) for m in _messages(seed))
    ct1, ct2 = (gates.lwe_ith_encrypt_bit(gen, m, i, keys[i], params.alpha, params.k, (BATCH,))
                for i, m in enumerate((m1, m2)))
    ct = gates.gate_affine(gates.GATE_IDS["NAND"], ct1, ct2)
    return (setup or mod.setup)(a, [p[-1] for p in parties], params), [p[-1] for p in parties], ct, ct2, \
        lambda out: gates.lwe_decrypt_bit_mk(out, keys)


def engine_case(name: str, device, seed: int = 3) -> dict:
    """One engine's bootstrap at a tiny set, keys made on `device`:
    bootstrap, scheme, extra (the keys it carries besides the scheme),
    params, a NAND batch `ct` of party 0's m1 and party 1's m2, the
    encryption `c2` of m2 (a chain's second operand) and the decryption."""
    if name in ("cggi.bootstrap", "batchminor.bootstrap_bm", "fused_step.bootstrap_fused"):
        params = TEST_PRESETS["TinyCGGI"]
        scheme, ct, c2, decrypt = _single_key(params, cggi.setup, device, seed)
        bootstrap = {"cggi.bootstrap": cggi.bootstrap, "batchminor.bootstrap_bm": batchminor.bootstrap_bm,
                     "fused_step.bootstrap_fused": fused_step.bootstrap_fused}[name]
        if name != "cggi.bootstrap":
            scheme = batchminor.convert_scheme(scheme, params)
        return dict(bootstrap=bootstrap, scheme=scheme, extra=(), params=params, ct=ct, c2=c2, decrypt=decrypt)
    if name == "lmss.bootstrap":
        scheme, ct, c2, decrypt = _single_key(LMSS_TINY, lmss.setup, device, seed)
        return dict(bootstrap=lmss.bootstrap, scheme=scheme, extra=(), params=LMSS_TINY, ct=ct, c2=c2, decrypt=decrypt)
    if name == "ccs.bootstrap":
        scheme, _, ct, c2, decrypt = _multi_key(ccs, CCS_TINY, device, seed)
        return dict(bootstrap=ccs.bootstrap, scheme=scheme, extra=(), params=CCS_TINY, ct=ct, c2=c2, decrypt=decrypt)
    # the mx engine needs N % 128 == 0: TinyKMS2partyMX is TinyKMS2party at N = 128
    params = {"fused_mx3.bootstrap_mx3 block": KMS_TINY_BLOCK,
              "fused_mx2.bootstrap_mx2": TEST_PRESETS["TinyKMS2partyMX"]}.get(name, TEST_PRESETS["TinyKMS2party"])
    setup = fused_mx2.setup if name == "fused_mx2.bootstrap_mx2" else None
    scheme, party_keys, ct, c2, decrypt = _multi_key(kms, params, device, seed, setup)
    extra = ()
    if name == "kms.bootstrap_bm":
        extra = (batchminor.build_bm_kms_phase1(party_keys, params),)
    if extra:
        scheme = kms.drop_brk(scheme)
    bootstrap = {"kms.bootstrap": kms.bootstrap, "fused_mx3.bootstrap_mx3": fused_mx3.bootstrap_mx3,
                 "fused_mx3.bootstrap_mx3 block": fused_mx3.bootstrap_mx3, "kms.bootstrap_bm": kms.bootstrap_bm,
                 "fused_mx2.bootstrap_mx2": fused_mx2.bootstrap_mx2}[name]
    return dict(bootstrap=bootstrap, scheme=scheme, extra=extra, params=params, ct=ct, c2=c2, decrypt=decrypt)


ENGINES = ["fused_mx3.bootstrap_mx3", "fused_mx3.bootstrap_mx3 block", "fused_mx2.bootstrap_mx2", "kms.bootstrap",
           "kms.bootstrap_bm", "fused_step.bootstrap_fused", "batchminor.bootstrap_bm", "cggi.bootstrap",
           "lmss.bootstrap", "ccs.bootstrap"]


def run(case: dict, ct: Lwe | None = None, scheme=None) -> Lwe:
    return case["bootstrap"](case["ct"] if ct is None else ct, case["scheme"] if scheme is None else scheme,
                             *case["extra"], case["params"])


def _refuse(*args, **kwargs):
    raise AssertionError("the bootstrap read a tensor's value back to the host or copied host data into one")


@contextlib.contextmanager
def patched(obj, names):
    saved = {name: getattr(obj, name) for name in names}
    try:
        for name in names:
            setattr(obj, name, _refuse)
        yield
    finally:
        for name, fn in saved.items():
            setattr(obj, name, fn)


# what reads a value back to the host (a sync on the card), and what copies host data into a tensor
HOST_READS = ("item", "tolist", "__int__", "__bool__", "__float__", "__index__")
HOST_COPIES = ("tensor", "as_tensor", "from_numpy")


def _equal(x: Lwe, y: Lwe) -> bool:
    return torch.equal(x.b, y.b) and torch.equal(x.a, y.a)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["torus32", "torus64"])
@pytest.mark.parametrize("big_n", [64, 128, 256, 512, 1024, 2048])
def test_mod_switch_lies_in_0_2n(dtype, big_n):
    """tildeb and tildea lie in [0, 2N) for the extreme carriers (0, all
    ones, the sign bit alone, the largest positive value, the values that
    round up to 2N and wrap) and for random ones; each is round(x 2N / 2^T)
    mod 2N of the carrier read as unsigned, in Python integers."""
    t = bits_of(dtype)
    top = 1 << (t - 1)
    step = 1 << (t - (big_n.bit_length() - 1) - 1)  # 2^T / 2N
    extremes = [0, -1, -top, top - 1, 1, -(step // 2), -(step // 2) - 1, step // 2, step // 2 - 1]
    rng = np.random.default_rng(big_n + t)
    info = np.iinfo(np.int32 if t == 32 else np.int64)
    rand = rng.integers(info.min, info.max, size=64, endpoint=True).tolist()
    values = extremes + rand
    b = torch.tensor(values, dtype=dtype)
    a = torch.tensor([values, values[::-1]], dtype=dtype).T.contiguous()
    tb, ta = mod_switch_2n(Lwe(b=b, a=a), big_n)
    for got, src in ((tb, b), (ta, a)):
        got = got.reshape(-1).tolist()
        assert min(got) >= 0 and max(got) < 2 * big_n
        want = [((v % (1 << t)) * 2 * big_n + (1 << t) // 2) // (1 << t) % (2 * big_n) for v in src.reshape(-1).tolist()]
        assert got == want


@pytest.mark.parametrize("name", ENGINES)
def test_bootstrap_makes_no_host_read(name):
    """The bootstrap with every host read patched to raise, then once more
    with the host copies patched too (its constant tables made by the first
    call and cached); both decrypt to the NAND and agree."""
    case = engine_case(name, CPU)
    with patched(torch.Tensor, HOST_READS):
        first = run(case)
    with patched(torch.Tensor, HOST_READS), patched(torch, HOST_COPIES):
        again = run(case)
    assert _equal(first, again)
    m1, m2 = _messages(3)
    assert torch.equal(case["decrypt"](first), ~(m1 & m2))


def test_wrappers_still_read_the_range():
    """The public wrappers keep their range check: it is the one host read,
    and it raises under the patch; the bootstrap paths call their private
    forms, which skip it."""
    case = engine_case("fused_mx3.bootstrap_mx3", CPU)
    params, brk = case["params"], case["scheme"].brk_hat[0]
    ctx = kms._ctx(params)
    _, tildea = mod_switch_2n(case["ct"], params.big_n)
    ta = tildea[:, : params.n].contiguous()
    with patched(torch.Tensor, HOST_READS), pytest.raises(AssertionError):
        fused_mx3.phase1_sweep(ta, brk, 1, case["scheme"].mono_hat, params, ctx)
    with patched(torch.Tensor, HOST_READS):
        got = fused_mx3._sweep(ta, brk, 1, case["scheme"].mono_hat, params, ctx)
    assert torch.equal(got, fused_mx3.phase1_sweep(ta, brk, 1, case["scheme"].mono_hat, params, ctx))


@pytest.mark.parametrize("name", ["fused_mx3.bootstrap_mx3", "fused_mx2.bootstrap_mx2", "kms.bootstrap_bm",
                                  "fused_step.bootstrap_fused", "cggi.bootstrap", "lmss.bootstrap", "ccs.bootstrap"])
def test_graphed_on_cpu_is_the_eager_function(name):
    """On a CPU ciphertext there is no graph: the call is the eager
    function's, bit for bit, on the capture's example and on another batch
    of the same shape; the keys it holds are the scheme's and the extra
    keys' tensors; no launch is counted."""
    case = engine_case(name, CPU)
    graphed = capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    assert graphed.graph is None and graphed.launches == {}
    assert _equal(graphed(case["ct"], case["scheme"], *case["extra"], case["params"]), run(case))
    other = Lwe(b=case["ct"].b.flip(0).contiguous(), a=case["ct"].a.flip(0).contiguous())
    assert _equal(graphed(other, case["scheme"], *case["extra"], case["params"]), run(case, other))
    held = {id(t) for t in graphed.keys}
    for obj in (case["scheme"], *case["extra"]):
        assert all(id(getattr(obj, f.name)) in held for f in dataclasses.fields(obj))


def refusals(case: dict) -> dict:
    """Calls a graph captured on `case` must refuse: name -> (ct, scheme,
    rest)."""
    ct, scheme, rest = case["ct"], case["scheme"], (*case["extra"], case["params"])
    copy = dataclasses.replace(scheme)
    out = {
        "batch": (Lwe(b=ct.b[:-1], a=ct.a[:-1]), scheme, rest),
        "dtype": (Lwe(b=ct.b.long(), a=ct.a.long()), scheme, rest),
        "width": (Lwe(b=ct.b, a=ct.a[:, :-1]), scheme, rest),
        "scheme": (ct, copy, rest),
        "params": (ct, scheme, (*case["extra"], dataclasses.replace(case["params"]))),
        "arguments": (ct, scheme, rest[:-1]),
    }
    if case["extra"]:
        out["keys"] = (ct, scheme, (dataclasses.replace(case["extra"][0]), case["params"]))
    return out


@pytest.mark.parametrize("name", ["fused_mx2.bootstrap_mx2", "fused_step.bootstrap_fused", "kms.bootstrap_bm"])
def test_graphed_refuses_what_it_does_not_hold(name):
    case = engine_case(name, CPU)
    graphed = capture_bootstrap(case["bootstrap"], case["scheme"], case["params"], case["ct"], *case["extra"])
    for what, (ct, scheme, rest) in refusals(case).items():
        with pytest.raises(ValueError):
            graphed(ct, scheme, *rest)
