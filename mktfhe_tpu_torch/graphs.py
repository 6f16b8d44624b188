"""Gate bootstraps captured and replayed as CUDA graphs: the port's `jax.jit`.

Every bootstrap entry point of the JAX package is `jax.jit`-compiled, its
n-step rotation a `lax.scan`, so one call is one device program.  The port's
bootstraps dispatch op by op from Python, and the host's launches, not the
card, set the pace of the per-step engines (`cggi.bootstrap`, `lmss`, `ccs`,
the batch-minor engines).  `capture_bootstrap` records one whole bootstrap,
every launch of it (the hand kernels and PyTorch's own), into one
`torch.cuda.CUDAGraph`; a `GraphedBootstrap` replays it: one host launch a
bootstrap, whatever its steps.

A graph holds the addresses it was captured with, so the replay copies the
ciphertext into the capture's static inputs, and it refuses what the graph
does not hold: a ciphertext of another batch, width, dtype or device, and
any scheme, key or parameter object other than the captured ones.  It keeps
those objects, and with them every key tensor the graph reads, alive: a
scheme rebuilt by `kms.drop_brk` or `setup` cannot free a key under it.  Its
output is a fresh `Lwe` (a clone of the graph's own), so a chain can feed one
output to the next call.

What a capture needs of the bootstrap: no host read (the kernel wrappers'
reads of tildea's range are skipped on the bootstrap paths,
`kernels.fused_mx3.check_tildea_range`), no copy from the host (the constant
tables are made once per device and cached: the warm-up call makes them) and
the same shapes on every call.  A capture that fails raises: on a CUDA
tensor there is no eager fallback.  On a CPU ciphertext there is no graph:
`capture_bootstrap` returns an object that refuses the same things and calls
the eager function, as the kernel wrappers run their plain versions on CPU
tensors.

The kernel wrappers count launches when they are called; during a capture
that launches nothing.  So `capture_bootstrap` takes back what the capture
added to the counts, and each replay adds it again: the counts stay those
of the kernels that ran.

The named phase ranges (utils/profiling.py) are host annotations, which a
replay does not open, and `event_ranges` records no event during a capture.
`capture_bootstrap(..., ranges=True)` captures the bootstrap with an
external recorder active instead: each range's edges become event-record
nodes of the graph, every replay records them, and
`GraphedBootstrap.range_ms()` reads the last replay's split by range name,
as `event_ranges` reads an eager one's.  Without it the graph holds no
event node.  A replay opens the host spans `mktfhe/graph/inputs`,
`mktfhe/graph/launch` and `mktfhe/graph/outputs` (profiling.host_span)
around its copies, its launch and its output's clones.

`capture_sharded` does the same for a rank of the party-sharded bootstrap
(parallel/shardmap.py), the counterpart of the JAX package's `jax.jit` over
its sharded programs.  The rank's program is a list of segments and the
collectives between them.  Over NCCL the whole program, collectives
included, is one graph.  Over gloo, whose collectives stage through the
host and cannot be captured, each run of segments between two collectives
is a graph of its own, and a replay runs the collectives between them,
from and into the buffers the graphs hold.  All graphs of one capture share
one memory pool, captured in the order they replay.

A capture's allocations are carved from one segment of its pool, as large
as the eager warm-up's transients (its peak less what it leaves allocated;
`_reserve_arena`): where they grow from step to step, as phase 2's merges
do, each would otherwise reserve a segment of its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch
import torch.distributed as dist

from .ciphertext.lwe import Lwe
from .kernels import fused_mx2, fused_mx3, fused_step
from .kernels import ntt as kntt
from .kernels.hybrid_product import hybrid_product
from .utils import profiling

# the kernel wrappers whose `launches` (and, for the NTTs, `shapes`) count
_COUNTED = (fused_mx3.phase1_sweep, fused_mx2.mx_sweep, fused_step.cggi_step, hybrid_product,
           kntt.fwd_ntt_nat, kntt.inv_ntt_nat, kntt.fwd_ntt_bm, kntt.inv_ntt_bm)
# counters beside a wrapper's launches: the party sweeps the sweep's launches served
_SERVED = ((fused_mx3.phase1_sweep, "parties"),)


def _counts() -> dict:
    counts = {(w, "launches"): (w.launches, dict(getattr(w, "shapes", {}))) for w in _COUNTED}
    counts.update({(w, attr): (getattr(w, attr), {}) for w, attr in _SERVED})
    return counts


def _name(counter: tuple) -> str:
    w, attr = counter
    return w.__name__ if attr == "launches" else f"{w.__name__}.{attr}"


def launch_counts() -> dict:
    """Each counted wrapper's launches since its reset, in all and by shape:
    name -> (launches, {shape: launches}); and the counters beside them
    (`phase1_sweep.parties`: the party sweeps served) as name.counter ->
    (count, {})."""
    return {_name(c): counts for c, counts in _counts().items()}


def _change(before: dict, after: dict) -> dict:
    """What a call added to each counter: (wrapper, counter) -> (count,
    {shape: launches})."""
    out = {}
    for c, (n0, s0) in before.items():
        n1, s1 = after[c]
        shapes = {k: v - s0.get(k, 0) for k, v in s1.items() if v != s0.get(k, 0)}
        if n1 != n0 or shapes:
            out[c] = (n1 - n0, shapes)
    return out


def _add(change: dict, sign: int = 1) -> None:
    for (w, attr), (n, shapes) in change.items():
        setattr(w, attr, getattr(w, attr) + sign * n)
        for k, v in shapes.items():
            left = w.shapes.get(k, 0) + sign * v
            if left:
                w.shapes[k] = left
            else:
                w.shapes.pop(k, None)


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor field of a scheme, key container or params object."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        fields = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple):
        fields = list(obj)
    else:
        return []
    return [t for x in fields for t in _tensors(x)]


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a graph captured with keep_graph=True (`cuGraphGetNodes` of
    libcuda)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    libcuda.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(int(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return count.value


@dataclasses.dataclass(eq=False, kw_only=True)
class _Graphed:
    """What a capture holds and measured.  `batch`: (b's shape, a's shape,
    dtype, device) of the ciphertexts it takes; `keys`: every tensor of the
    scheme and the key objects (kept alive); `inputs` / `output`: the
    graphs' static ciphertexts; `change`: each counted wrapper's launches a
    replay.  The capture's numbers: `warmup_s` (the eager warm-up call, to
    its end on the card), `warmup_peak_bytes` (the device's allocation peak
    during the warm-up, the peak statistics reset before it),
    `warmup_transient_bytes` (that peak above what is still allocated
    after the warm-up: its transients, not the tables and the output it
    keeps), `capture_s`, `instantiate_s`, `pool_bytes`
    (device memory the capture reserved above what was held: the graphs'
    intermediates and outputs), `pool_peak_bytes` (the most of it allocated
    at once during the capture), `nodes` (of all its graphs) and
    `warmup_out` (the warm-up's eager output)."""

    batch: tuple
    keys: tuple = ()
    inputs: tuple = ()
    output: Lwe | None = None
    change: dict = dataclasses.field(default_factory=dict)
    warmup_out: Lwe | None = None
    warmup_s: float = 0.0
    warmup_peak_bytes: int = 0
    warmup_transient_bytes: int = 0
    capture_s: float = 0.0
    instantiate_s: float = 0.0
    pool_bytes: int = 0
    pool_peak_bytes: int = 0
    nodes: int = 0

    @property
    def key_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in {id(t): t for t in self.keys}.values())

    @property
    def launches(self) -> dict:
        return {_name(c): n for c, (n, _) in self.change.items()}

    def _refuse(self, ct: Lwe, scheme, rest: tuple, held: tuple) -> None:
        """Refuse a call whose scheme or other arguments are not the captured
        objects, or whose ciphertext has another shape, dtype or device."""
        if scheme is not self.scheme:
            raise ValueError("this graph was captured with another scheme object")
        if len(rest) != len(held) or any(x is not y for x, y in zip(rest, held)):
            raise ValueError("this graph was captured with other keys, parameters or mesh")
        b_shape, a_shape, dtype, device = self.batch
        got = (tuple(ct.b.shape), tuple(ct.a.shape), ct.b.dtype, ct.b.device)
        if got != self.batch or ct.a.dtype != dtype or ct.a.device != device:
            raise ValueError(f"this graph takes ciphertexts b {list(b_shape)}, a {list(a_shape)} of {dtype} on "
                             f"{device}; got b {list(got[0])}, a {list(got[1])} of {ct.b.dtype} / {ct.a.dtype} "
                             f"on {ct.b.device}")

    def _replayed(self, ct: Lwe, replay) -> Lwe:
        """ct copied into the static inputs, replay(), the launch counts
        added, and a fresh copy of the static output."""
        b_in, a_in = self.inputs
        with profiling.host_span("mktfhe/graph/inputs"):
            b_in.copy_(ct.b)
            a_in.copy_(ct.a)
        with profiling.host_span("mktfhe/graph/launch"):
            replay()
            _add(self.change)
        with profiling.host_span("mktfhe/graph/outputs"):
            return Lwe(b=self.output.b.clone(), a=self.output.a.clone())

    @contextlib.contextmanager
    def _capturing(self, example_ct: Lwe, warmup, side: torch.cuda.Stream):
        """The frame of a capture on the card: warmup() on the side stream,
        timed to its end; the static inputs; the device's memory baseline
        (its peak statistics reset, the cache emptied); yields a list for
        the graphs the block captures and a memory pool for them; then takes
        back what the capture counted, instantiates the graphs and takes
        their numbers."""
        device = example_ct.b.device
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):  # the stream the capture runs on (its cuBLAS workspace)
            self.warmup_out = warmup()
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        self.warmup_peak_bytes = torch.cuda.max_memory_allocated(device)
        self.warmup_transient_bytes = self.warmup_peak_bytes - torch.cuda.memory_allocated(device)
        self.inputs = (example_ct.b.clone(), example_ct.a.clone())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reserved, allocated = torch.cuda.memory_reserved(device), torch.cuda.memory_allocated(device)
        graphs = []
        before = _counts()
        t0 = time.perf_counter()
        try:
            yield graphs, torch.cuda.graph_pool_handle()
        finally:  # nothing ran: take back what the wrappers counted
            self.change = _change(before, _counts())
            _add(self.change, -1)
        self.capture_s = time.perf_counter() - t0
        self.pool_peak_bytes = torch.cuda.max_memory_allocated(device) - allocated
        t0 = time.perf_counter()
        for graph in graphs:
            graph.instantiate()
        torch.cuda.synchronize(device)
        self.instantiate_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.nodes = sum(_graph_nodes(graph) for graph in graphs)


def _reserve_arena(nbytes: int, device) -> None:
    """Called first in a capture (the first graph of a pool): one block of
    `nbytes` (`_Graphed.warmup_transient_bytes`) allocated in the graph's
    pool and freed at once, so that the capture's allocations are carved
    from one segment.  Without it a bootstrap whose transients grow from
    step to step (phase 2's merges, a component more each) finds no freed
    block large enough for the next step's and reserves a new segment each
    time (at KMS32partyblock, batch 128, eight times its peak)."""
    if nbytes > 0:
        torch.empty(nbytes, dtype=torch.uint8, device=device)  # freed at once; its segment stays in the pool


def _side_stream(device) -> torch.cuda.Stream:
    """A new stream on `device` that waits for the current one's work."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    return side


@dataclasses.dataclass(eq=False, kw_only=True)
class GraphedBootstrap(_Graphed):
    """`bootstrap(ct, scheme, *extra, params)` as one CUDA graph; called as
    the eager function is.  `graph` is None on the CPU; `recorder` holds the
    graph's range events (captured with ranges=True), else None.  The
    numbers: those of `_Graphed`; `launches` (each counted wrapper's
    launches a replay: name -> count)."""

    bootstrap: object
    scheme: object
    extra: tuple
    params: object
    graph: torch.cuda.CUDAGraph | None = None
    recorder: profiling._Recorder | None = None

    def __call__(self, ct: Lwe, scheme, *rest) -> Lwe:
        self._refuse(ct, scheme, rest, (*self.extra, self.params))
        if self.graph is None:
            return self.bootstrap(ct, scheme, *rest)
        return self._replayed(ct, self.graph.replay)

    def range_ms(self) -> dict[str, float]:
        """The last replay's device ms by range name, each range less the
        ranges opened inside it, once its last event is complete; called
        after a replay.  Empty where the graph holds no ranges (captured
        without them, or on the CPU)."""
        rec = self.recorder
        if rec is None or rec.last is None:
            return {}
        rec.last.synchronize()
        return rec.exclusive_ms()


def capture_bootstrap(bootstrap, scheme, params, example_ct: Lwe, *extra, ranges: bool = False) -> GraphedBootstrap:
    """`bootstrap(ct, scheme, *extra, params)` for ciphertexts shaped as
    `example_ct`, captured into one CUDA graph after one eager warm-up call
    (which builds the kernels and their constant tables), on a side stream,
    into the graph's own memory pool (the device's peak-memory statistics
    are reset to measure it), which the capture opens with one segment as
    large as the warm-up's transients (`_reserve_arena`).  ranges: the
    capture (not the warm-up) runs with an external recorder active, so the
    graph holds a timing-event pair at the edges of every named range
    (`range_ms`).  On a CPU ciphertext: no graph, the eager function behind
    the same refusals."""
    device = example_ct.b.device
    graphed = GraphedBootstrap(
        bootstrap=bootstrap, scheme=scheme, extra=tuple(extra), params=params,
        batch=(tuple(example_ct.b.shape), tuple(example_ct.a.shape), example_ct.b.dtype, device),
        keys=tuple(t for obj in (scheme, *extra) for t in _tensors(obj)),
    )
    if device.type == "cpu":
        return graphed
    if device.type != "cuda":
        raise ValueError(f"no graph for device {device}")
    with torch.cuda.device(device):
        side = _side_stream(device)
        with graphed._capturing(example_ct, lambda: bootstrap(example_ct, scheme, *extra, params), side) as (
                graphs, pool):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            rec = profiling._Recorder(external=True) if ranges else None
            with torch.cuda.graph(graph, pool=pool, stream=side):
                _reserve_arena(graphed.warmup_transient_bytes, device)
                with profiling.recording(rec) if ranges else contextlib.nullcontext():
                    graphed.output = bootstrap(Lwe(*graphed.inputs), scheme, *extra, params)
            graphs.append(graph)
            graphed.recorder = rec
        graphed.graph = graph
    return graphed


@dataclasses.dataclass(eq=False, kw_only=True)
class GraphedSharded(_Graphed):
    """A rank's sharded bootstrap, `program(scheme, params, mesh, gates,
    *extra)`'s steps (parallel/shardmap.py), as CUDA graphs; called as the
    eager entry point is: (ct, scheme, params, mesh, *extra).  `replay`: in
    order, each graph and each collective between them (the collective, the
    state it read at the capture, the buffer it writes); `graphs`: the
    graphs alone (empty on the CPU, where a call runs `steps` eagerly);
    `whole`: one graph holds the whole program, collectives included (NCCL).
    The numbers: those of `_Graphed`."""

    program: object
    scheme: object
    params: object
    mesh: object
    extra: tuple
    steps: list
    whole: bool = False
    replay: list = dataclasses.field(default_factory=list)

    @property
    def graphs(self) -> list:
        return [item for item in self.replay if isinstance(item, torch.cuda.CUDAGraph)]

    def _run(self) -> None:
        for item in self.replay:
            if isinstance(item, torch.cuda.CUDAGraph):
                item.replay()
            else:
                step, state, out = item
                step.fn(state, out)

    def __call__(self, ct: Lwe, scheme, *rest) -> Lwe:
        from .parallel.shardmap import run_program

        self._refuse(ct, scheme, rest, (self.params, self.mesh, *self.extra))
        if not self.replay:
            return run_program(self.steps, ct)
        return self._replayed(ct, self._run)


def capture_sharded(program, example_ct: Lwe, scheme, params, mesh, *extra,
                    by_segment: bool | None = None) -> GraphedSharded:
    """A rank's sharded bootstrap for ciphertexts shaped as `example_ct`:
    `program(scheme, params, mesh, gates, *extra)` (`shardmap_program` or
    `sharded_program`) captured after one eager warm-up run, on a side
    stream, into one memory pool.  Every rank of the mesh calls it at the
    same point, as it would the eager bootstrap.  by_segment: None by the
    backend (NCCL: the whole program as one graph, its collectives
    included; gloo: a graph per run of segments, the collectives eager
    between them); True takes the segments' graphs over NCCL too (the
    collectives then run eagerly between them); gloo refuses False.  A
    capture that fails raises.  On a CPU ciphertext: no graph, the warm-up
    run all the same (its output and seconds), and calls run the eager
    program behind the same refusals."""
    from .parallel.shardmap import Collective, program_input, program_output, run_program, run_steps

    device = example_ct.b.device
    steps = program(scheme, params, mesh, example_ct.b.shape[0], *extra)
    graphed = GraphedSharded(
        program=program, scheme=scheme, params=params, mesh=mesh, extra=tuple(extra), steps=steps,
        batch=(tuple(example_ct.b.shape), tuple(example_ct.a.shape), example_ct.b.dtype, device),
        keys=tuple(t for obj in (scheme, *extra) for t in _tensors(obj)),
    )
    if device.type == "cpu":
        t0 = time.perf_counter()
        graphed.warmup_out = run_program(steps, example_ct)
        graphed.warmup_s = time.perf_counter() - t0
        return graphed
    if device.type != "cuda":
        raise ValueError(f"no graph for device {device}")
    nccl = dist.get_backend() == "nccl"
    if by_segment is False and not nccl:
        raise ValueError("gloo's collectives stage through the host and cannot be captured: by_segment")
    graphed.whole = nccl and not by_segment
    with torch.cuda.device(device):
        side = _side_stream(device)
        # the warm-up also makes every communicator the program uses, before any capture
        with graphed._capturing(example_ct, lambda: run_program(steps, example_ct), side) as (graphs, pool):
            state = program_input(Lwe(*graphed.inputs))
            if graphed.whole:
                runs = [steps]
            else:  # the steps cut at the collectives: runs of segments, and the collectives alone
                runs = []
                for step in steps:
                    if isinstance(step, Collective) or not runs or isinstance(runs[-1], Collective):
                        runs.append(step if isinstance(step, Collective) else [step])
                    else:
                        runs[-1].append(step)
            with torch.cuda.stream(side):
                for run in runs:
                    if isinstance(run, Collective):  # eager: its buffer is the one every replay writes
                        out = run.fn(state, None)
                        graphed.replay.append((run, dict(state), out))
                        state[run.name] = out
                        continue
                    graph = torch.cuda.CUDAGraph(keep_graph=True)
                    # thread_local: NCCL's watchdog thread may query its events meanwhile
                    with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
                        if not graphs:
                            _reserve_arena(graphed.warmup_transient_bytes, device)
                        state = run_steps(run, state)
                    graphs.append(graph)
                    graphed.replay.append(graph)
        graphed.output = program_output(state)
    return graphed


def without_sync(fn, *args):
    """fn(*args) with every synchronizing CUDA call an error
    (`torch.cuda.set_sync_debug_mode("error")`): the check that a bootstrap
    makes no host read and no blocking copy, which no graph could hold.  On
    the card only (the mode needs CUDA)."""
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(previous)
