"""Port parity of `utils/profiling.py`.

The cost model's counts equal the JAX package's as integers for every
preset and engine; `summary` takes no device's peaks by default; `trace`
on the CPU records the bootstraps' named phase ranges in order (KMS phase 1
party by party on `kms.bootstrap`, every party's sweeps in one range on
`bootstrap_mx3`) and leaves their output bits unchanged, and `gates.gate` opens its host spans before
them; `_Recorder.exclusive_ms` charges nested ranges exclusively;
`capture_bootstrap(..., ranges=True)` on the CPU is the eager function and
reads no range; `charge_gaps` and `idle_by_span` put each idle gap of the
device down to the innermost span open at its start.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from mktfhe_tpu.schemes import params as jparams
from mktfhe_tpu.schemes.presets import ALL_PRESETS
from mktfhe_tpu.utils import profiling as jprof
from mktfhe_tpu_torch import bridge, graphs
from mktfhe_tpu_torch.kernels import fused_mx3
from mktfhe_tpu_torch.schemes import cggi, gates, kms
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


def _kms_inputs():
    params = TEST_PRESETS["TinyKMS2party"]
    gen = torch.Generator().manual_seed(5)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    m = torch.tensor([True, False, True])
    cts = [lwe_ith_encrypt_bit(gen, m, i, parties[i][0], params.alpha, params.k, (3,)) for i in range(2)]
    return cts, scheme, params


def _phase2_ranges(params) -> list[str]:
    ranges = []
    for p1 in range(1, params.k + 1):
        ranges += [f"mktfhe/phase2/merge{p1}", "mktfhe/phase2/hybrid"]
    return [*ranges, "mktfhe/keyswitch"]


def _kms_case():
    cts, scheme, params = _kms_inputs()
    ranges = ["mktfhe/mod_switch"]
    for party in range(params.k):
        ranges += [f"mktfhe/phase1/party{party}", "mktfhe/levkey_lift"]
    return kms.bootstrap, cts, scheme, params, ranges + _phase2_ranges(params)


def _kms_mx3_case():
    """`bootstrap_mx3`: every party's sweeps in one range, then each
    party's lift."""
    cts, scheme, params = _kms_inputs()
    ranges = ["mktfhe/mod_switch", "mktfhe/phase1/sweeps", *["mktfhe/levkey_lift"] * params.k]
    return fused_mx3.bootstrap_mx3, cts, scheme, params, ranges + _phase2_ranges(params)


def _cggi_case():
    params = TEST_PRESETS["TinyCGGI"]
    gen = torch.Generator().manual_seed(6)
    lwe_key, _, scheme = cggi.setup(gen, params)
    cts = [lwe_encrypt_bit(gen, torch.tensor([True, False]), lwe_key, params.alpha, (2,)) for _ in range(2)]
    return cggi.bootstrap, cts, scheme, params, ["mktfhe/mod_switch", "mktfhe/rotate", "mktfhe/keyswitch"]


def _spans(prof) -> list[tuple[int, int, str]]:
    """The named ranges and spans of a profile, (start ns, end ns, name) in
    the order they opened on the host."""
    return sorted(((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name().startswith(profiling.PREFIX)),
                  key=lambda span: (span[0], -span[1]))


def _range_names(prof) -> list[str]:
    return [name for _, _, name in _spans(prof)]


CASES = pytest.mark.parametrize("case", [_kms_case, _kms_mx3_case, _cggi_case], ids=["kms", "kms_mx3", "cggi"])


@CASES
def test_trace_records_the_named_ranges(case, tmp_path):
    bootstrap, cts, scheme, params, ranges = case()
    ct = gate_affine(0, *cts)
    want = bootstrap(ct, scheme, params)
    with profiling.trace(str(tmp_path)) as prof:
        got = bootstrap(ct, scheme, params)
    assert _range_names(prof) == ranges
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)
    assert (tmp_path / "trace.json").stat().st_size > 0


@CASES
def test_gate_opens_its_spans_then_the_bootstraps_ranges(case, tmp_path):
    """`gates.gate` opens `mktfhe/gate`, inside it `mktfhe/gate/affine`,
    closed before the bootstrap's ranges open, all of them inside
    `mktfhe/gate`; the bits are the affine and bootstrap's."""
    bootstrap, cts, scheme, params, ranges = case()
    want = bootstrap(gate_affine(0, *cts), scheme, params)
    with profiling.trace(str(tmp_path)) as prof:
        got = gates.gate("NAND", *cts, lambda ct: bootstrap(ct, scheme, params))
    spans = _spans(prof)
    assert [name for _, _, name in spans] == ["mktfhe/gate", "mktfhe/gate/affine", *ranges]
    (g0, g1, _), (a0, a1, _), rest = spans[0], spans[1], spans[2:]
    assert g0 <= a0 <= a1 <= rest[0][0] and all(g0 <= s0 <= s1 <= g1 for s0, s1, _ in rest)
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


class _StubEvent:
    """A CUDA event stand-in recorded at a set time (ms)."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms


def test_exclusive_ms_charges_nested_ranges_exclusively():
    """Each range's time less the ranges opened inside it, summed by name
    in order of first opening: the values add up to the outermost ranges'
    time."""
    rec = profiling._Recorder()
    ev = _StubEvent
    rec.ranges = [["a", ev(0), ev(10), None], ["b", ev(2), ev(5), 0], ["c", ev(6), ev(8), 0],
                  ["d", ev(10), ev(20), None], ["b", ev(12), ev(13), 3], ["a", ev(20), ev(25), None]]
    got = rec.exclusive_ms()
    assert got == {"a": 10.0, "b": 4.0, "c": 2.0, "d": 9.0}
    assert list(got) == ["a", "b", "c", "d"]
    assert sum(got.values()) == 25.0


def test_capture_with_ranges_on_cpu_is_the_eager_function():
    """On a CPU ciphertext a capture with ranges is the eager bootstrap,
    and reads no range."""
    bootstrap, cts, scheme, params, _ = _kms_case()
    ct = gate_affine(0, *cts)
    want = bootstrap(ct, scheme, params)
    graphed = graphs.capture_bootstrap(bootstrap, scheme, params, ct, ranges=True)
    got = graphed(ct, scheme, params)
    assert graphed.graph is None and graphed.recorder is None
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)
    assert graphed.range_ms() == {}


def test_charge_gaps_to_the_innermost_open_span():
    """A gap goes to the latest-opened span that holds its start, else to
    NO_SPAN; the seconds add up to the gaps' total."""
    spans = [(0, 100, "bench/issue"), (10, 60, "mktfhe/gate"), (20, 30, "mktfhe/gate/affine"),
             (40, 50, "mktfhe/graph/launch"), (200, 300, "bench/wait")]
    gaps = [(5, 15), (25, 45), (45, 47), (55, 150), (101, 111), (150, 160), (301, 311), (400, 1000)]
    got = profiling.charge_gaps(gaps, spans)
    assert got == pytest.approx({"bench/issue": 10e-9, "mktfhe/gate/affine": 20e-9, "mktfhe/graph/launch": 2e-9,
                                 "mktfhe/gate": 95e-9, profiling.NO_SPAN: 630e-9}, abs=1e-15)
    assert sum(got.values()) == pytest.approx(sum(g1 - g0 for g0, g1 in gaps) / 1e9, abs=1e-15)
    assert profiling.charge_gaps(gaps, []) == pytest.approx({profiling.NO_SPAN: 757e-9}, abs=1e-15)


def _event(name: str, start: int, end: int, device: bool = False, annotation: bool = False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                           duration_ns=lambda: end - start, device_type=lambda: kind,
                           is_user_annotation=lambda: annotation)


def test_idle_by_span_reads_the_gaps_between_device_rows():
    """Over a stub profile: the device's idle time between its rows (the
    ranges' own device rows skipped), charged to the innermost span; with
    a window, from its start to its end with the rows clipped to it, so the
    idle seconds are the window less the busy time."""
    events = [
        _event("bench/window", 0, 1000, annotation=True),
        _event("bench/issue", 90, 510, annotation=True),
        _event("mktfhe/gate", 100, 500, annotation=True),
        _event("mktfhe/gate/affine", 100, 200, annotation=True),
        _event("mktfhe/graph/launch", 300, 400, annotation=True),
        _event("mktfhe/gate", 0, 1000, device=True, annotation=True),  # a range's device row
        _event("aten::add", 120, 130),  # a host operator
        _event("kernel", -50, 50, device=True), _event("kernel", 150, 180, device=True),
        _event("kernel", 250, 350, device=True), _event("copy", 380, 900, device=True),
        _event("kernel", 400, 420, device=True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    got = profiling.idle_by_span(prof, prefixes=("mktfhe/", "bench/"), window="bench/window")
    assert got == pytest.approx({profiling.NO_SPAN: 200e-9, "mktfhe/gate/affine": 70e-9,
                                 "mktfhe/graph/launch": 30e-9}, abs=1e-15)
    assert sum(got.values()) == pytest.approx((1000 - 50 - 30 - 100 - 520) / 1e9, abs=1e-15)
    got = profiling.idle_by_span(prof)  # no window: from the first row to the last; mktfhe/ spans alone
    assert got == pytest.approx({profiling.NO_SPAN: 100e-9, "mktfhe/gate/affine": 70e-9,
                                 "mktfhe/graph/launch": 30e-9}, abs=1e-15)
    assert profiling.idle_by_span(prof, window="bench/none") == {}
