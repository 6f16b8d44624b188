"""Profiling: named phase ranges, the device time of each range (from CUDA
events at the ranges' edges, eager or inside a captured graph), host spans
on the gate path, the device's idle gaps by the span open at their start,
and the static cost model of a bootstrap.

Port of mktfhe_tpu/utils/profiling.py.

Named ranges.  The bootstraps mark their phases with `phase_range`: a
`torch.profiler.record_function` range, host-side only (no
synchronisation, no device work, nothing per CMux step), and, while an
`event_ranges` recorder is active, a pair of CUDA events on the current
stream at its edges:

  mktfhe/mod_switch           modulus switch of the input to Z_2N
  mktfhe/phase1/party{i}      KMS phase 1 of party i (0-based)
  mktfhe/phase1/sweeps        KMS phase 1's sweeps of every party in one call
                              (`bootstrap_mx3`), their lifts after it
  mktfhe/levkey_lift          its lev key lifted into the primes and transformed
  mktfhe/phase2/merge{p1}     KMS phase-2 merge of party p1 (1-based)
  mktfhe/phase2/hybrid        inside each merge, its hybrid product
  mktfhe/rotate               the blind rotation of CGGI, LMSS and CCS
  mktfhe/keyswitch            modulus switch to 2^32 (KMS) and key switch

`event_ranges` gives each range's device time between its edges, less the
ranges opened inside it, after one synchronisation at its end.  The time
between two events holds the gaps where the card idled too, so its sum
equals the bootstrap's device time only on a path the host does not hold
back.  It records no event while a CUDA graph is captured, or where there
is no card.  A graph captured with ranges (graphs.capture_bootstrap(...,
ranges=True)) holds its ranges' events instead: an external recorder
(`_Recorder(external=True)`) is active during the capture, its events
become event-record nodes of the graph, and every replay records them
anew.

Host spans.  `host_span` is a bare `record_function` range (no CUDA
event) on the gate path, around what the host does between two
bootstraps:

  mktfhe/gate                 schemes.gates.gate: the affine, then the bootstrap
  mktfhe/gate/affine          its affine combination
  mktfhe/graph/inputs         a replay's copies into the graph's static inputs
  mktfhe/graph/launch         the replay's launch and its launch counts
  mktfhe/graph/outputs        the clones of the graph's static output

Their timestamps are on the profiler's clock, the clock of a trace's
device rows: `idle_by_span` charges each idle gap of the device to the
innermost span open on the host when it began.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile

import torch
from torch.profiler import record_function

PREFIX = "mktfhe/"
NO_SPAN = "host outside every span"


class _Recorder:
    """The CUDA events of the ranges opened while the recorder is active:
    per range its name, its edges and the range it was opened in.
    `external`: events a graph's capture turns into event-record nodes,
    which every replay records again."""

    def __init__(self, external: bool = False):
        self.external = external
        self.ranges = []  # [name, start event, end event, index of the enclosing range or None]
        self.open = []  # indices of the ranges open now, innermost last
        self.last = None  # the end event recorded last

    def _event(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True, external=self.external)
        event.record()
        return event

    def enter(self, name: str) -> None:
        self.ranges.append([name, self._event(), None, self.open[-1] if self.open else None])
        self.open.append(len(self.ranges) - 1)

    def exit(self) -> None:
        self.last = self.ranges[self.open.pop()][2] = self._event()

    def exclusive_ms(self) -> dict[str, float]:
        """ms by name of each range less the ranges opened inside it, names
        in order of first opening (the events must have completed)."""
        own = [start.elapsed_time(end) for _, start, end, _ in self.ranges]
        excl = list(own)
        for i, (_, _, _, parent) in enumerate(self.ranges):
            if parent is not None:
                excl[parent] -= own[i]
        out = {}
        for (name, *_), ms in zip(self.ranges, excl):
            out[name] = out.get(name, 0.0) + ms
        return out


_recorder: _Recorder | None = None  # the active recorder, read by every `phase_range`


@contextlib.contextmanager
def phase_range(name: str):
    """A named phase range around the block: a `record_function` range, and
    while a recorder is active a CUDA event on the current stream at each
    edge (while the stream is being captured into a CUDA graph, only an
    external recorder's)."""
    with record_function(name):
        rec = _recorder
        if rec is None or (not rec.external and torch.cuda.is_current_stream_capturing()):
            yield
            return
        rec.enter(name)
        try:
            yield
        finally:
            rec.exit()


@contextlib.contextmanager
def recording(rec: _Recorder):
    """`rec` the active recorder in the block, the one active before it
    after."""
    global _recorder
    before, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = before
    if rec.open:
        raise RuntimeError(f"ranges still open at the end of the recording: {[rec.ranges[i][0] for i in rec.open]}")


@contextlib.contextmanager
def event_ranges():
    """Time the named ranges opened in the block by CUDA events: yields a
    dict that holds, after the block, the ms of each range name between its
    edges, less the ranges opened inside it (so the values add up to the
    time inside the outermost ranges), after one synchronisation.  Where
    there is no card it records nothing and the dict stays empty.  Does not
    nest."""
    ms = {}
    if not torch.cuda.is_available():
        yield ms
        return
    if _recorder is not None:
        raise RuntimeError("event_ranges is active already")
    with recording(_Recorder()) as rec:
        yield ms
    torch.cuda.synchronize()
    ms.update(rec.exclusive_ms())


def host_span(name: str):
    """A named span of host work on the gate path: a bare `record_function`
    range, which records no CUDA event (so `event_ranges` does not see it)
    and costs a few microseconds without a profiler."""
    return record_function(name)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """torch.profiler around a region: CPU activity, plus CUDA where there
    is a card.  On exit the Chrome trace is written to `logdir`/trace.json
    (default: mktfhe_trace under the temporary directory).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    logdir = os.path.join(tempfile.gettempdir(), "mktfhe_trace") if logdir is None else logdir
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def charge_gaps(gaps, spans) -> dict[str, float]:
    """Seconds of idle gaps by the host span open at each gap's start.
    gaps: (start_ns, end_ns); spans: (start_ns, end_ns, name), on one
    clock.  A gap goes to the innermost span open at its start (the
    latest-opened one containing it), else to NO_SPAN; the values add up to
    the gaps' total.  One pass over both in order of their starts."""
    spans = sorted(spans, key=lambda span: (span[0], -span[1]))  # of two opened at once, the outer first
    out, opened, i = {}, [], 0
    for g0, g1 in sorted(gaps):
        while i < len(spans) and spans[i][0] <= g0:
            opened.append(spans[i])
            i += 1
        while opened and opened[-1][1] < g0:  # the spans above the innermost open one have closed
            opened.pop()
        name = opened[-1][2] if opened else NO_SPAN
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out


def idle_by_span(prof, prefixes=(PREFIX,), window: str | None = None) -> dict[str, float]:
    """The device's idle seconds in a torch.profiler profile by the host
    span open at the start of each gap (`charge_gaps`), over the spans
    whose names start with one of `prefixes`.  The idle time is what lies
    outside the union of the device rows (kernels, copies, fills; the
    ranges' own device rows are skipped), from the first row to the last;
    with `window`, the name of a host range (not itself a span), from that
    range's start to its end, the rows clipped to it.  Empty without device
    rows."""
    cpu = torch.autograd.DeviceType.CPU
    spans, rows, edges = [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            if e.device_type() != cpu:
                continue
            if e.name() == window:
                edges = (e.start_ns(), e.end_ns())
            elif e.name().startswith(tuple(prefixes)):
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() != cpu and e.duration_ns() > 0:
            rows.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if window is not None:
        if edges is None:
            return {}
        rows = [(max(s, edges[0]), min(e, edges[1])) for s, e in rows if e > edges[0] and s < edges[1]]
    if not rows:
        return {}
    rows.sort()
    start, end = (rows[0][0], rows[-1][1]) if edges is None else edges
    gaps, cur = [], start
    for s, e in rows:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end))
    return charge_gaps(gaps, spans)


def _digit_split(log_b: int) -> int:
    """Number of bf16 operands per gadget digit in the JAX package's MXU
    engines (kernels/fused_mx2.py there): one up to log_b = 9, two above."""
    return 1 if log_b <= 9 else 2


@dataclasses.dataclass
class BootstrapCost:
    """Static per-gate cost model of a blind rotation + key switch, counted
    as the JAX package counts it (its TPU's units of work)."""

    ntt_elems: int  # element-passes through NTT butterflies
    vpu_ops: int  # estimated scalar integer ops outside the matrix unit
    mxu_macs: int  # multiply-accumulates of the matrix unit (key switch; mx engines' transforms)
    hbm_bytes: int  # bootstrapping-key bytes streamed per batch

    def summary(self, batch: int, measured_s: float, *, peak_vpu: float, peak_mxu: float, peak_hbm: float) -> dict:
        """Bounds against a device's peaks, which the caller must give (no
        device's are assumed): peak_vpu integer operations/s, peak_mxu
        multiply-accumulates/s of the unit that runs the matmuls, peak_hbm
        device-memory bytes/s."""
        per_gate = measured_s / batch
        return {
            "ms_per_gate": per_gate * 1e3,
            "vpu_bound_ms": self.vpu_ops / peak_vpu * 1e3,
            "mxu_bound_ms": self.mxu_macs / peak_mxu * 1e3,
            "hbm_bound_ms_batch": self.hbm_bytes / peak_hbm * 1e3,
            "vpu_utilization": self.vpu_ops / peak_vpu / per_gate,
        }


def kms_cost(params, engine: str = "mx", nprimes: int = 3) -> BootstrapCost:
    """Per-gate cost of a KMS two-phase bootstrap, the JAX package's count.

    engine: 'ref'/'bm' count the NTT butterflies as vector ops (a Shoup
    modmul ~11 u32 ops, a butterfly ~14); 'mx'/'mx2' count the TPU's
    128-point MXU factoring of each transform (bf16 limb matmuls) and the
    vector stages left beside it.  The port's mx sweep kernel (B5) does not
    run that arithmetic: the card's own bound for each kernel is counted in
    that kernel's arithmetic by chip_smoke.py (`sweep_step_ops`).
    """
    n, big_n, k = params.n, params.big_n, params.k
    l, l_lev = params.l_gsw, params.l_lev
    logn = int(math.log2(big_n))
    cpl = 2 * l  # decomposed digit polys per step (2 components x l)
    rows = l_lev  # uniform RLEV rows in phase 1

    # phase 1, per party per step: cpl fwd + 2 inv transforms, 2*cpl*2
    # pointwise muls, mono weight, decomp+Garner overhead
    fwd_elems = cpl * nprimes * big_n * logn // 2  # butterflies
    inv_elems = 2 * nprimes * big_n * logn // 2
    pointwise = nprimes * big_n * (cpl * 2 + 2)
    glue = big_n * (10 * cpl + 30)  # decomp digits + Garner + u64 adds
    if engine in ("mx", "mx2"):
        nb = big_n // 128
        s_count = int(math.log2(nb)) if nb > 1 else 0
        stage_elems = (cpl + 2) * nprimes * big_n * (s_count + 2) // 2
        vpu_step = stage_elems * 14 + pointwise * 11 + glue
        nsplit = _digit_split(params.log_b_gsw)
        mxu_step = nprimes * 128 * 128 * (cpl * nb * 4 * nsplit + 2 * nb * 16)
    else:
        vpu_step = (fwd_elems + inv_elems) * 14 + pointwise * 11 + glue
        mxu_step = 0
    p1_vpu = k * rows * n * vpu_step
    p1_mxu = k * rows * n * mxu_step

    # phase 2, party p1: LEV contract (p1*l_lev fwd + 2 inv round trips),
    # hybrid product (~(p1*l_uni + l_uni) fwd + 2 inv + p1+2 out inv)
    p2_ntt_polys = sum(
        p1 * l_lev + 2 + p1 * params.l_uni + params.l_uni + (p1 + 2) for p1 in range(1, k + 1)
    )
    p2_vpu = p2_ntt_polys * nprimes * big_n * logn // 2 * 14

    ks_macs = 4 * k * params.f * big_n * (n + 1)
    brk_bytes = k * n * nprimes * cpl * 2 * big_n * 4 * 2
    return BootstrapCost(
        ntt_elems=(fwd_elems + inv_elems) * 2 * k * rows * n,
        vpu_ops=p1_vpu + p2_vpu,
        mxu_macs=p1_mxu + ks_macs,
        hbm_bytes=brk_bytes,
    )


def lmss_cost(params, nprimes: int = 2) -> BootstrapCost:
    """Per-gate cost of an LMSS block-binary bootstrap: one decomposition +
    (k+1)*l forward transforms per block (d blocks), ell monomial-weighted
    external products accumulated in the evaluation domain, then k+1
    inverses."""
    big_n, k, l, d, ell = params.big_n, params.k, params.l_gsw, params.d, params.ell
    logn = int(math.log2(big_n))
    fwd = (k + 1) * l * nprimes * big_n * logn // 2
    inv = (k + 1) * nprimes * big_n * logn // 2
    # per member: external product (k+1)^2*l products + monomial weight
    pointwise = ell * big_n * nprimes * ((k + 1) * (k + 1) * l + (k + 1))
    per_block = (fwd + inv) * 14 + pointwise * 11 + big_n * 40
    vpu = d * per_block
    tail = k * big_n - d * ell  # coefficients beyond the free head
    ks_macs = 4 * tail * params.f * (1 << (params.log_d - 1)) * (d * ell + 1)
    brk_bytes = d * ell * (k + 1) * l * (k + 1) * nprimes * big_n * 4 * 2
    return BootstrapCost(ntt_elems=d * (fwd + inv) * 2, vpu_ops=vpu, mxu_macs=ks_macs, hbm_bytes=brk_bytes)


def ccs_cost(params, nprimes: int = 2) -> BootstrapCost:
    """Per-gate cost of a CCS hybrid-product bootstrap: for party index idx
    (1-based), each of n steps decomposes idx+1 components (l digits each),
    forward-transforms them twice (acc digits, then v digits), computes
    u/v/w pointwise, and inverse-transforms v (idx+1) and the output
    (idx+1), as the JAX package counts it."""
    n, big_n, k, l = params.n, params.big_n, params.k, params.l_uni
    logn = int(math.log2(big_n))
    vpu = 0
    ntt_elems = 0
    for idx in range(1, k + 1):
        comps = idx + 1
        fwd = 2 * comps * l * nprimes * big_n * logn // 2  # acc + v digits
        inv = 2 * comps * nprimes * big_n * logn // 2  # v + output
        # u: comps*l products; v: comps*l; w: 2*comps*l (b and a rows)
        pointwise = big_n * nprimes * (4 * comps * l + 2)
        vpu += n * ((fwd + inv) * 14 + pointwise * 11 + big_n * 40)
        ntt_elems += n * (fwd + inv) * 2
    ks_macs = 4 * k * big_n * params.f * (1 << (params.log_d - 1)) * (n + 1)
    brk_bytes = k * n * l * 3 * nprimes * big_n * 4 * 2  # d + f stacks
    return BootstrapCost(ntt_elems=ntt_elems, vpu_ops=vpu, mxu_macs=ks_macs, hbm_bytes=brk_bytes)


def cggi_cost(params, nprimes: int = 2) -> BootstrapCost:
    """Per-gate cost of a CGGI bootstrap."""
    n, big_n, k, l = params.n, params.big_n, params.k, params.l_gsw
    logn = int(math.log2(big_n))
    fwd = (k + 1) * l * nprimes * big_n * logn  # butterfly elements
    inv = (k + 1) * nprimes * big_n * logn
    pointwise = big_n * nprimes * (k + 1) * (k + 1) * l
    per_step = (fwd + inv) // 2 * 14 + pointwise * 16
    vpu = n * per_step
    ks_macs = 4 * (k * big_n * params.f) * (n + 1)
    brk_bytes = n * (k + 1) * l * (k + 1) * nprimes * big_n * 4 * 2
    return BootstrapCost(ntt_elems=n * (fwd + inv), vpu_ops=vpu, mxu_macs=ks_macs, hbm_bytes=brk_bytes)
