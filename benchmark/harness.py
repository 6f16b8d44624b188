"""One run of one cell: set-up, the measured window, the checks, the result.

Everything a cell is made of is found by name: its entry in BENCHMARK.json,
its configuration file, its traffic file (`traffic/<name>.json`), the
scheme family's reference and adapter (`reference/<family>.py`,
`adapters/<family>.py`) and one reader per per-layer metric
(`metrics/<name>.py`, a function `read(readings)` that returns a number or
None).  A cell, a traffic mix or a metric is added as files and entries;
nothing here names one.

The window drives the user's entry, `schemes.gates.gate`, with the cell's
engine captured as one CUDA graph at the cell's width: a chain of circuit
layers, each W two-input gates whose first inputs are the last layer's
outputs and whose second are fresh ciphertexts of the parties in turn,
ops drawn uniformly from the gate set.  It is closed-loop: a layer is
issued when the last is complete on the device, and its time runs on the
host clock from its issue to that point.  Each layer's outputs are copied
to host memory once complete, so the card holds no more of them than the
chain needs, and judged after the window: every gate decrypted against the
clear circuit, and whole lanes drawn from the seed (one gate position
through every layer) bootstrapped again by the plain reference, whose words
must equal the program's.
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "mktfhe_tpu")
OPS_TABLE_LAYERS = 4096  # layers of drawn ops; a longer window repeats them
REF_BLOCK = 128  # gates a call of the reference bootstraps at once


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, with its configuration,
    traffic and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / bench["paths"][0]
    config = json.loads((root / conf["file"]).read_text())
    config.setdefault("name", conf["name"])
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)], bench_dir=bench_dir)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cell: Cell):
    """(reference, adapter) modules of the configuration's scheme family."""
    fam = cell.config["family"]
    pkg = cell.bench_dir.name
    return (importlib.import_module(f"{pkg}.reference.{fam}"), importlib.import_module(f"{pkg}.adapters.{fam}"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the reference's parameter set, the
    width, the capture's numbers, the key set-up's seconds, the window's
    wall time, each layer's host-clock seconds and (traced runs) each replay's device time by CUDA events, the
    split of one eager bootstrap by the program's named ranges (median ms of
    each range over a few bootstraps) and its rotation amounts."""

    params: object
    width: int
    graphed: dict
    key_setup_s: float
    window_s: float
    layer_s: list
    layer_busy_ms: list | None = None
    phase_ms: dict = dataclasses.field(default_factory=dict)
    tildea: torch.Tensor | None = None  # [W, k, n] of the eager bootstrap's input


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _faulty(bootstrap, fault: str | None):
    """The timed path broken underneath (for the harness's own tests):
    'unchanged' returns its input; 'half' computes only the first half of
    the batch and repeats it; 'flip' negates one output (its bit flips);
    'words' adds 1 to every output's first mask word (no bit flips)."""
    if fault is None:
        return bootstrap

    def broken(ct, *rest):
        if fault == "unchanged":
            return ct
        out = bootstrap(ct, *rest)
        b, a = out.b.clone(), out.a.clone()
        if fault == "half":
            h = b.shape[0] // 2
            b[h:2 * h], a[h:2 * h] = b[:h], a[:h]
        elif fault == "flip":
            b[-1], a[-1] = -b[-1], -a[-1]
        elif fault == "words":
            a[:, 0] += 1
        else:
            raise ValueError(f"unknown fault {fault}")
        return type(out)(b=b, a=a)

    return broken


class _Outputs:
    """Each layer's output (b [W], a [W, k*n]) copied to host memory, pinned
    on a card, on a side stream once the layer is complete: the card then
    holds only the chain's current inputs, whatever the window's length."""

    def __init__(self, like, capacity: int, device):
        self.pin = device.type == "cuda"
        self.b = torch.empty((capacity, *like.b.shape), dtype=like.b.dtype, pin_memory=self.pin)
        self.a = torch.empty((capacity, *like.a.shape), dtype=like.a.dtype, pin_memory=self.pin)
        self.stream = torch.cuda.Stream(device) if self.pin else None
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def add(self, y) -> None:
        if self.n == len(self.b):  # the window ran longer than its estimate
            self.wait()
            self.b = torch.cat([self.b, torch.empty_like(self.b, pin_memory=self.pin)])
            self.a = torch.cat([self.a, torch.empty_like(self.a, pin_memory=self.pin)])
        if self.stream is None:
            self.b[self.n].copy_(y.b)
            self.a[self.n].copy_(y.a)
        else:
            self.stream.wait_stream(torch.cuda.current_stream(y.b.device))
            with torch.cuda.stream(self.stream):
                self.b[self.n].copy_(y.b, non_blocking=True)
                self.a[self.n].copy_(y.a, non_blocking=True)
            y.b.record_stream(self.stream)
            y.a.record_stream(self.stream)
        self.n += 1

    def wait(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float, fault: str | None = None,
        control: bool = False, log=print) -> tuple[dict, list[str]]:
    """One run of the cell.  Returns the result (all but `device`'s
    platform fields, which the caller adds) and the lines of the numbers
    compared, each beside its limit.  `control` puts the reference in the
    program's place, its ring products in float64, and takes no graph;
    `fault` breaks the timed path underneath (`_faulty`)."""
    ref, ad = family(cell)
    device = torch.device(device)
    params = ref.KmsSet.from_config(cell.config["params"])
    port_params = ad.params(cell.config)
    ad.check_gates()
    traffic = cell.traffic
    if traffic.get("parties", "cycle") != "cycle":
        raise ValueError(f"traffic {traffic}: the parties take their turns in a cycle ('cycle')")
    width, k = traffic["width"], params.k
    pool_batches = traffic["pool_batches"]

    # set-up: the libraries, the evaluator's key set-up, the input pool, the
    # capture.  The benchmark's own work is off its clock: the parties' keys,
    # made by the reference on the card from the seed as each party makes its
    # own, and the host store of the window's outputs.  The keys come from
    # the radix-2 ring (`ExactRing`), whose transients leave the allocator as
    # the program's key set-up has always found it: what that set-up reserves
    # is part of `device_reserved_gb`.  The checks use the faster `MatrixRing`
    # (the same words), after the window.
    if device.type == "cuda":
        ad.build()
        torch.zeros(1, device=device)  # the context, on the set-up clock
        _sync(device)
    tp = time.perf_counter()
    ring = ref.ExactRing(params.big_n, device)
    crs = ref.crs(params, seed, device)
    secrets = [ref.party_secrets(params, seed, p, device) for p in range(k)]
    keys = [ad.party_key(ref.party_keys(params, seed, p, crs, ring)) for p in range(k)]
    _sync(device)
    parties_s = time.perf_counter() - tp
    ts = time.perf_counter()
    scheme = ad.setup(crs, keys, port_params)
    _sync(device)
    key_setup_s = time.perf_counter() - ts
    del keys
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    gen = ref.generator(device, seed, "traffic")
    ops_ids = torch.tensor([ref.GATE_NAMES.index(g) for g in traffic["gates"]], device=device)
    ops = ops_ids[torch.randint(0, len(ops_ids), (OPS_TABLE_LAYERS, width), generator=gen, device=device)]
    bits = ref.binary(gen, (pool_batches + 1, width))
    party = torch.arange((pool_batches + 1) * width, device=device).reshape(pool_batches + 1, width) % k
    pool_b, pool_a = ref.encrypt_bits(gen, bits, party, secrets, params.alpha)
    pool = [ad.lwe(pool_b[i], pool_a[i]) for i in range(pool_batches + 1)]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    engine = ad.engine(cell.config["engine"])
    if not control:
        graphed = ad.capture(engine, scheme, port_params, ad.affine(ops[0], pool[0], pool[1]))
        captured = {f: getattr(graphed, f) for f in ("warmup_s", "capture_s", "instantiate_s", "nodes", "pool_bytes",
                                                     "pool_peak_bytes")}
        call = _faulty(graphed, fault)
    else:
        lower = ref.F64Ring(params.big_n, device)
        graphed, captured = None, {}

        def call(ct, *rest):
            return ad.lwe(*ref.bootstrap(lower, params, ct.b, ct.a, seed, crs))

    def boot(ct):
        return call(ct, scheme, port_params)

    for i in range(2):  # the gate path's own kernels, outside the window
        tl = time.perf_counter()
        y = ad.gate(ops[i], pool[0], pool[1 + i], boot)
        _sync(device)
        layer_est = time.perf_counter() - tl
    ts = time.perf_counter()
    outs = _Outputs(y, int(seconds / layer_est * 1.25) + 4, device)  # the benchmark's own: off the clock
    store_s = time.perf_counter() - ts
    del y
    setup_s = time.perf_counter() - t0 - parties_s - store_s
    log(f"[bench] {cell.name}: set-up {setup_s:.2f} s (key set-up {key_setup_s:.2f} s, capture {captured}); "
        f"off its clock: the parties' keys, made by the reference, {parties_s:.2f} s, the host store of the "
        f"outputs {store_s:.2f} s", file=sys.stderr)

    # the window
    layer_s, marks = [], []
    prof = None
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        # a layer under the profiler before the window: the tracer's first
        # launches of the graph and kernels fall outside it
        tl = time.perf_counter()
        ad.gate(ops[0], pool[0], pool[1], boot)
        _sync(device)
        log(f"[bench] first layer under the profiler {time.perf_counter() - tl:.3f} s (outside the window)",
            file=sys.stderr)
    x = pool[0]
    window_range = record_function("bench/window") if trace else None
    if window_range is not None:
        window_range.__enter__()

    def boot_marked(ct):
        """The replay between two CUDA events (its input copies and output
        clones with it), for `idle_share`."""
        if stream is None:
            return boot(ct)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = boot(ct)
        e1.record(stream)
        marks.append((e0, e1))
        return out

    start = time.perf_counter()
    deadline = start + seconds
    while True:
        i = len(outs)
        t_issue = time.perf_counter()
        if trace:
            with record_function("bench/issue"):
                y = ad.gate(ops[i % OPS_TABLE_LAYERS], x, pool[1 + i % pool_batches], boot_marked)
            with record_function("bench/wait"):
                _sync(device)
        else:
            y = ad.gate(ops[i % OPS_TABLE_LAYERS], x, pool[1 + i % pool_batches], boot)
            _sync(device)
        t_done = time.perf_counter()
        layer_s.append(t_done - t_issue)
        outs.add(y)
        x = y
        if t_done >= deadline:
            break
    window_end = time.perf_counter()
    window_s = window_end - start
    if prof is not None:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    reserved = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    outs.wait()
    del x, y
    layers = len(outs)
    slowest = max(range(layers), key=layer_s.__getitem__)
    log(f"[bench] window {window_s:.3f} s, {layers} layers of {width} gates; slowest layer {slowest} "
        f"{layer_s[slowest] * 1e3:.3f} ms, median {statistics.median(layer_s) * 1e3:.3f} ms", file=sys.stderr)

    readings = Readings(params=params, width=width, key_setup_s=key_setup_s, window_s=window_s, layer_s=layer_s,
                        graphed=captured)
    breakdown, busy = None, None
    if trace:
        if marks:
            readings.layer_busy_ms = [a.elapsed_time(b) for a, b in marks]
        ts = time.perf_counter()
        readings.phase_ms, readings.tildea = _eager_split(ref, ad, engine, scheme, port_params,
                                                          ad.affine(ops[0], pool[0], pool[1]), params)
        tp = time.perf_counter()
        busy, breakdown = _profile_summary(prof, window_s)
        log(f"[bench] traced: the profiler stopped in {ts - window_end:.1f} s, the eager split {tp - ts:.1f} s, "
            f"the profile's summary {time.perf_counter() - tp:.1f} s", file=sys.stderr)
    del graphed, call, scheme, boot
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the checks, once the window is closed and the program's state freed
    tc = time.perf_counter()
    clear = _clear_chain(ref, ops, bits, layers, pool_batches)
    tcl = time.perf_counter() - tc
    wrong, failed = _decrypt_check(ref, outs, clear, secrets, pool[0].b.device)
    td = time.perf_counter() - tc
    sample = _sample(seed, layers, width, traffic["check_lanes"], ref)
    mismatch, bad = _reference_check(ref, params, seed, crs, sample, outs, ops, pool, pool_batches)
    failed |= bad
    tr = time.perf_counter() - tc - td
    log(f"[bench] checks {time.perf_counter() - tc:.1f} s: {layers * width} gates decrypted ({td:.1f} s, the clear "
        f"circuit {tcl:.1f} s of it), {len(sample)} bootstrapped again by the reference ({tr:.1f} s, "
        f"{tr / max(1, len(sample)):.3f} s a gate)", file=sys.stderr)

    gates_done = layers * width
    values = {
        "gates_per_s": gates_done / window_s,
        "layer_ms_p90": percentile(layer_s, 90) * 1e3,
        "device_reserved_gb": reserved / 1e9,
        "setup_s": setup_s,
    }
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            reader = _module(cell.bench_dir / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
            v = reader.read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {
        "wrong_bits": {"value": wrong, "limit": 0},
        "mismatched_words": {"value": mismatch, "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": gates_done, "failed": len(failed), "metrics": metrics,
              "device": {"memory_peak_bytes": reserved}}
    if trace:
        result["device"].update({"busy_s": busy, "window_s": window_s})
        if breakdown:
            result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in checks.items()]
    log(f"[bench] from the window's end to the result {time.perf_counter() - window_end:.1f} s", file=sys.stderr)
    return result, lines


def _eager_split(ref, ad, engine, scheme, port_params, ct, params, reps: int = 3):
    """The program's named ranges of `reps` eager bootstraps of a layer's
    inputs, by CUDA events at their edges: the median ms of each range;
    and the inputs' rotation amounts [W, k, n]."""
    runs = []
    for _ in range(reps):
        with ad.event_ranges() as ms:
            engine(ct, scheme, port_params)
        runs.append(ms)
    phase_ms = {n: statistics.median(r.get(n, 0.0) for r in runs) for n in runs[0]}
    tildea = ref.mod_switch(ct.a, params.big_n).reshape(ct.a.shape[0], params.k, params.n)
    return phase_ms, tildea.cpu()


def _profile_summary(prof, window_s: float):
    """Device busy seconds in the traced window (the union of the device
    rows' intervals, clipped to the host's `bench/window` range: the
    profile also holds a layer before it) and the breakdown: the device
    operations that took most time, and the idle gaps by the host range
    open at their start."""
    if prof is None:
        return None, None
    cpu = torch.autograd.DeviceType.CPU
    rows, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            if e.device_type() == cpu and e.name() == "bench/window":
                window = (e.start_ns(), e.end_ns())
            elif e.device_type() == cpu and e.name().startswith("bench/"):
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() != cpu and e.duration_ns() > 0:
            rows.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    if window is None:
        return None, None
    dev_rows = [(max(s, window[0]), min(e, window[1]), n) for s, e, n in rows if e > window[0] and s < window[1]]
    if not dev_rows:
        return None, None
    dev_rows.sort()
    by_name: dict[str, float] = {}
    for s, e, name in dev_rows:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    busy, gaps = 0, []
    cur_s, cur_e = dev_rows[0][0], dev_rows[0][1]
    for s, e, _ in dev_rows[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    idle: dict[str, float] = {}
    for (g0, g1), name in zip(gaps, _gap_owners(gaps, host)):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    top = [(_short(n), t) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return busy / 1e9, {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gap_list]}


OUTSIDE = "host outside the bench ranges"


def _gap_owners(gaps: list, host: list) -> list[str]:
    """The host range each idle gap (start, end) goes to: of the ranges
    (start, end, name) that began at or before the gap's start and ended at
    or after it, the last in the order of (start, end, name); else OUTSIDE.
    Gaps and ranges are each sorted once and walked together: a heap holds
    the ranges begun so far by their rank in that order, and a range that
    ended before a gap's start is dropped for good, since no later gap
    starts earlier."""
    host = sorted(host)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0])
    owners, begun, nxt = [OUTSIDE] * len(gaps), [], 0
    for i in order:
        g0 = gaps[i][0]
        while nxt < len(host) and host[nxt][0] <= g0:
            heapq.heappush(begun, -nxt)
            nxt += 1
        while begun and host[-begun[0]][1] < g0:
            heapq.heappop(begun)
        if begun:
            owners[i] = host[-begun[0]][2]
    return owners


def _short(name: str, width: int = 120) -> str:
    """A device operation's name cut to `width` characters (the kernels'
    template arguments run to kilobytes)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def _clear_chain(ref, ops, bits, layers: int, pool_batches: int) -> torch.Tensor:
    """The circuit's bits in the clear: [layers, W]."""
    ops_c, bits_c = ops.cpu(), bits.cpu()
    x, out = bits_c[0], []
    for i in range(layers):
        x = ref.clear_gate(ops_c[i % OPS_TABLE_LAYERS], x, bits_c[1 + i % pool_batches])
        out.append(x)
    return torch.stack(out)


def _decrypt_check(ref, outs: _Outputs, clear: torch.Tensor, secrets, dev):
    """Every output decrypted against the clear circuit [layers, W]: (wrong
    bits, the set of (layer, gate) that failed)."""
    failed = set()
    for i in range(len(outs)):
        got = ref.decrypt(outs.b[i].to(dev), outs.a[i].to(dev), secrets).cpu()
        for g in torch.nonzero(got != clear[i]).flatten().tolist():
            failed.add((i, g))
    return len(failed), failed


def _sample(seed: int, layers: int, width: int, lanes: int, ref) -> list[tuple[int, int]]:
    """`lanes` gate positions drawn from the seed, each through every layer
    of the window: (layer, gate) pairs in which each gate's first input,
    the same lane's output a layer before, is itself in the sample (layer
    0's is the benchmark's own ciphertext)."""
    gen = torch.Generator().manual_seed(ref.sub_seed(seed, "sample"))
    gates = torch.randperm(width, generator=gen)[:min(lanes, width)].tolist()
    return [(l, g) for g in sorted(gates) for l in range(layers)]


def _reference_check(ref, params, seed, crs, sample, outs: _Outputs, ops, pool, pool_batches):
    """The sampled gates bootstrapped by the plain reference from the same
    inputs, `REF_BLOCK` at a time: words that differ from the program's."""
    dev = pool[0].b.device
    ring = ref.MatrixRing(params.big_n, dev)
    mismatch, bad = 0, set()
    for s0 in range(0, len(sample), REF_BLOCK):
        block = sample[s0:s0 + REF_BLOCK]
        layer = torch.tensor([l for l, _ in block], device=dev)
        gate = torch.tensor([g for _, g in block], device=dev)
        b1 = torch.stack([outs.b[l - 1, g].to(dev) if l else pool[0].b[g] for l, g in block])
        a1 = torch.stack([outs.a[l - 1, g].to(dev) if l else pool[0].a[g] for l, g in block])
        b2 = torch.stack([pool[1 + l % pool_batches].b[g] for l, g in block])
        a2 = torch.stack([pool[1 + l % pool_batches].a[g] for l, g in block])
        op = ops[layer % OPS_TABLE_LAYERS, gate]
        bb, aa = ref.gate_affine(op, b1, a1, b2, a2)
        rb, ra = ref.bootstrap(ring, params, bb, aa, seed, crs)
        pb = torch.stack([outs.b[l, g] for l, g in block]).to(dev)
        pa = torch.stack([outs.a[l, g] for l, g in block]).to(dev)
        diff = (rb != pb).long() + (ra != pa).long().sum(-1)
        mismatch += int(diff.sum())
        bad |= {block[i] for i in torch.nonzero(diff).flatten().tolist()}
    return mismatch, bad
