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
of the kernels that ran.  The named phase ranges (utils/profiling.py) are
host annotations and do not appear on a replay.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch

from .ciphertext.lwe import Lwe
from .kernels import fused_mx2, fused_mx3, fused_step
from .kernels import ntt as kntt

# the kernel wrappers whose `launches` (and, for the NTTs, `shapes`) count
_COUNTED = (fused_mx3.phase1_sweep, fused_mx2.mx_sweep, fused_step.cggi_step,
           kntt.fwd_ntt_nat, kntt.inv_ntt_nat, kntt.fwd_ntt_bm, kntt.inv_ntt_bm)


def _counts() -> dict:
    return {w: (w.launches, dict(getattr(w, "shapes", {}))) for w in _COUNTED}


def launch_counts() -> dict:
    """Each counted wrapper's launches since its reset, in all and by shape:
    name -> (launches, {shape: launches})."""
    return {w.__name__: counts for w, counts in _counts().items()}


def _change(before: dict, after: dict) -> dict:
    """What a call added to each wrapper's counts: wrapper -> (launches,
    {shape: launches})."""
    out = {}
    for w, (n0, s0) in before.items():
        n1, s1 = after[w]
        shapes = {k: v - s0.get(k, 0) for k, v in s1.items() if v != s0.get(k, 0)}
        if n1 != n0 or shapes:
            out[w] = (n1 - n0, shapes)
    return out


def _add(change: dict, sign: int = 1) -> None:
    for w, (n, shapes) in change.items():
        w.launches += sign * n
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


@dataclasses.dataclass(eq=False)
class GraphedBootstrap:
    """`bootstrap(ct, scheme, *extra, params)` as one CUDA graph; called as
    the eager function is.  `graph` is None on the CPU.  The capture's
    numbers: `warmup_s` (the eager warm-up call, to its end on the card),
    `capture_s`, `instantiate_s`, `pool_bytes` (device memory the graph's own
    pool reserved: its intermediates and outputs, above the keys),
    `pool_peak_bytes` (the most of it allocated at once during the capture),
    `nodes` (the graph's nodes), `launches` (each counted wrapper's launches a
    replay: name -> count) and `warmup_out` (the warm-up's eager output)."""

    bootstrap: object
    scheme: object
    extra: tuple
    params: object
    batch: tuple  # (b's shape, a's shape, dtype, device)
    keys: tuple = ()
    graph: torch.cuda.CUDAGraph | None = None
    inputs: tuple = ()
    output: Lwe | None = None
    change: dict = dataclasses.field(default_factory=dict)
    warmup_out: Lwe | None = None
    warmup_s: float = 0.0
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
        return {w.__name__: n for w, (n, _) in self.change.items()}

    def _refuse(self, ct: Lwe, scheme, rest: tuple) -> None:
        if scheme is not self.scheme:
            raise ValueError("this graph was captured with another scheme object")
        held = (*self.extra, self.params)
        if len(rest) != len(held) or any(x is not y for x, y in zip(rest, held)):
            raise ValueError("this graph was captured with other keys or parameters")
        b_shape, a_shape, dtype, device = self.batch
        got = (tuple(ct.b.shape), tuple(ct.a.shape), ct.b.dtype, ct.b.device)
        if got != self.batch or ct.a.dtype != dtype or ct.a.device != device:
            raise ValueError(f"this graph takes ciphertexts b {list(b_shape)}, a {list(a_shape)} of {dtype} on "
                             f"{device}; got b {list(got[0])}, a {list(got[1])} of {ct.b.dtype} / {ct.a.dtype} "
                             f"on {ct.b.device}")

    def __call__(self, ct: Lwe, scheme, *rest) -> Lwe:
        self._refuse(ct, scheme, rest)
        if self.graph is None:
            return self.bootstrap(ct, scheme, *rest)
        b_in, a_in = self.inputs
        b_in.copy_(ct.b)
        a_in.copy_(ct.a)
        self.graph.replay()
        _add(self.change)
        return Lwe(b=self.output.b.clone(), a=self.output.a.clone())


def capture_bootstrap(bootstrap, scheme, params, example_ct: Lwe, *extra) -> GraphedBootstrap:
    """`bootstrap(ct, scheme, *extra, params)` for ciphertexts shaped as
    `example_ct`, captured into one CUDA graph after one eager warm-up call
    (which builds the kernels and their constant tables), on a side stream,
    into the graph's own memory pool (the device's peak-memory statistics
    are reset to measure it).  On a CPU ciphertext: no graph, the eager
    function behind the same refusals."""
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
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):  # the stream the capture runs on (its cuBLAS workspace)
            graphed.warmup_out = bootstrap(example_ct, scheme, *extra, params)
        torch.cuda.synchronize(device)
        graphed.warmup_s = time.perf_counter() - t0
        graphed.inputs = (example_ct.b.clone(), example_ct.a.clone())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reserved, allocated = torch.cuda.memory_reserved(device), torch.cuda.memory_allocated(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=side):
                graphed.output = bootstrap(Lwe(*graphed.inputs), scheme, *extra, params)
        finally:  # nothing ran: take back what the wrappers counted
            graphed.change = _change(before, _counts())
            _add(graphed.change, -1)
        graphed.capture_s = time.perf_counter() - t0
        graphed.pool_peak_bytes = torch.cuda.max_memory_allocated(device) - allocated
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(device)
        graphed.instantiate_s = time.perf_counter() - t0
        graphed.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        graphed.nodes = _graph_nodes(graph)
        graphed.graph = graph
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
