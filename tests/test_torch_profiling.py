"""Port parity of `utils/profiling.py`.

The cost model's counts equal the JAX package's as integers for every
preset and engine; `summary` takes no device's peaks by default; `trace`
on the CPU records the bootstraps' named phase ranges in order and leaves
their output bits unchanged; `attribute` (the core of `phase_device_ms`)
charges each kernel to the innermost range open at its launch.
"""

import dataclasses

import pytest
import torch

from mktfhe_tpu.schemes import params as jparams
from mktfhe_tpu.schemes.presets import ALL_PRESETS
from mktfhe_tpu.utils import profiling as jprof
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.schemes import cggi, kms
from mktfhe_tpu_torch.schemes.gates import gate_affine, lwe_encrypt_bit, lwe_ith_encrypt_bit
from mktfhe_tpu_torch.schemes.presets import TEST_PRESETS
from mktfhe_tpu_torch.utils import profiling

ENGINES = ("ref", "bm", "mx", "mx2")


def _costs(params):
    """(label, JAX cost, port cost) of every cost function and engine that
    applies to the preset, at the default prime count and at the preset's."""
    tparams = bridge.params(params)
    if isinstance(params, (jparams.KmsParams, jparams.KmsBlockParams)):
        return [(f"{e}/{npr}", jprof.kms_cost(params, e, npr), profiling.kms_cost(tparams, e, npr))
                for e in ENGINES for npr in (3, params.ring_nprimes)]
    fns = {jparams.CggiParams: "cggi_cost", jparams.BlockParams: "lmss_cost", jparams.CcsParams: "ccs_cost"}
    name = fns[type(params)]
    return [(f"{name}/{npr}", getattr(jprof, name)(params, npr), getattr(profiling, name)(tparams, npr))
            for npr in (2, params.nprimes)]


@pytest.mark.parametrize("preset", list(ALL_PRESETS))
def test_cost_counts_match_jax(preset):
    for label, want, got in _costs(ALL_PRESETS[preset]):
        assert dataclasses.asdict(got) == dataclasses.asdict(want), label
        assert all(type(v) is int for v in dataclasses.asdict(got).values()), label


def test_summary_takes_the_peaks_from_the_caller():
    cost = profiling.kms_cost(ALL_PRESETS["KMS8party"], "ref")
    with pytest.raises(TypeError):
        cost.summary(128, 0.5)
    peaks = dict(peak_vpu=33.5e12, peak_mxu=33.5e12, peak_hbm=3.35e12)
    got = cost.summary(128, 0.5, **peaks)
    want = jprof.kms_cost(ALL_PRESETS["KMS8party"], "ref").summary(128, 0.5, **peaks)
    assert got == pytest.approx(want, rel=1e-12)


def _kms_case():
    params = TEST_PRESETS["TinyKMS2party"]
    gen = torch.Generator().manual_seed(5)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    m = torch.tensor([True, False, True])
    cts = [lwe_ith_encrypt_bit(gen, m, i, parties[i][0], params.alpha, params.k, (3,)) for i in range(2)]
    ranges = ["mktfhe/mod_switch"]
    for party in range(params.k):
        ranges += [f"mktfhe/phase1/party{party}", "mktfhe/levkey_lift"]
    ranges += [f"mktfhe/phase2/merge{p1}" for p1 in range(1, params.k + 1)] + ["mktfhe/keyswitch"]
    return kms.bootstrap, gate_affine(0, *cts), scheme, params, ranges


def _cggi_case():
    params = TEST_PRESETS["TinyCGGI"]
    gen = torch.Generator().manual_seed(6)
    lwe_key, _, scheme = cggi.setup(gen, params)
    cts = [lwe_encrypt_bit(gen, torch.tensor([True, False]), lwe_key, params.alpha, (2,)) for _ in range(2)]
    return cggi.bootstrap, gate_affine(0, *cts), scheme, params, ["mktfhe/mod_switch", "mktfhe/rotate", "mktfhe/keyswitch"]


def _range_names(prof) -> list[str]:
    """The named ranges of a profile, in the order they opened on the host."""
    events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name().startswith(profiling.PREFIX))
    return [name for _, name in events]


@pytest.mark.parametrize("case", [_kms_case, _cggi_case], ids=["kms", "cggi"])
def test_trace_records_the_named_ranges(case, tmp_path):
    bootstrap, ct, scheme, params, ranges = case()
    want = bootstrap(ct, scheme, params)
    with profiling.trace(str(tmp_path)) as prof:
        got = bootstrap(ct, scheme, params)
    assert _range_names(prof) == ranges
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert profiling.phase_device_ms(prof) == {**{name: 0.0 for name in ranges}, profiling.OUTSIDE: 0.0}


def test_attribute_charges_the_innermost_open_range():
    ranges = [(0, 100, "mktfhe/a"), (10, 20, "mktfhe/b"), (200, 300, "mktfhe/c")]
    launches = {1: 5, 2: 15, 3: 50, 4: 250, 5: 150}
    kernels = [(1, 1e6), (2, 2e6), (3, 4e6), (4, 8e6), (5, 16e6), (6, 32e6)]  # 6: no launch seen
    got = profiling.attribute(ranges, launches, kernels)
    assert got == {"mktfhe/a": 5.0, "mktfhe/b": 2.0, "mktfhe/c": 8.0, profiling.OUTSIDE: 48.0}
    assert list(got) == ["mktfhe/a", "mktfhe/b", "mktfhe/c", profiling.OUTSIDE]
