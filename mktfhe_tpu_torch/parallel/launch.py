"""Start ranks of a torch.distributed program, and the sharded bootstrap's
rank program.

`run_ranks(fn, world, backend, args, device_type)` spawns `world`
processes (`torch.multiprocessing.spawn`, which a parent that has touched
CUDA requires), joins them into one process group by a rendezvous file in
a temporary directory (no TCP port is picked, so concurrent runs cannot
collide), calls `fn(device, *args)` in each, and returns each rank's
result with its tensors as numpy arrays (int32 / int64 carriers as uint32 /
uint64, as `bridge.to_numpy`).  The backend is the caller's choice and is
never switched: "nccl" for one rank per card, "gloo" for CPU ranks or for
several ranks sharing one card (NCCL refuses two ranks on one device; gloo
stages the collectives through host memory, the compute stays on the card).
A rank's device is cuda:(rank % device_count()), or the CPU when
device_type is "cpu" (one thread a rank).

`bootstrap_jobs` is the rank program of `kms_bootstrap_shardmap` /
`kms_bootstrap_sharded`: every rank loads the keys and the ciphertext from
.npz files (`utils.serialization`; files of the JAX package's `save` will
do) and keeps its parties' share (`shard_scheme`), or loads only its share
from a file of its own (`mesh.party_share`, saved by the parent: at k = 32
a whole file is 13 GB, which four ranks on one host would each read),
bootstraps, and reports the output, the kernel launches, the time, the
bytes of keys it held and read, and its host and device memory.  A graphed
job also captures the rank's program as CUDA graphs
(`graphs.capture_sharded`, whose eager warm-up is the job's last eager
bootstrap) and replays it, in the same process on the same keys.

On a card, two ranks sharing cuda:0 over gloo (`main`):
    python -m mktfhe_tpu_torch.parallel --preset TinyKMS2party --world 2 --backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..bridge import to_numpy

TIMEOUT = datetime.timedelta(seconds=600)
# main's NAND batch (8 gates: 4 a rank of the gate split at --world 2) and seed
MAIN_BATCH = 8
MAIN_SEED = 0


def _host(x):
    """Tensors of a result (in dicts and lists) as numpy."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_host(v) for v in x]
    return x


def _rank_main(rank: int, fn, world: int, backend: str, device_type: str, tmp: str, args: tuple) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    # NCCL is told its device; gloo takes the tensors' own
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            world_size=world, rank=rank, timeout=TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    try:
        out = _host(fn(device, *args))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, backend: str, args: tuple = (), device_type: str = "cuda") -> list:
    """Run fn(device, *args) in `world` ranks of one process group over
    `backend`; returns the ranks' results in rank order, tensors as numpy.
    fn must be importable by name (a module-level function of this
    package).  A rank that raises makes this raise."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false; pass device_type='cpu'")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, world, backend, device_type, tmp, args),
                                    nprocs=world, join=True)
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


@dataclasses.dataclass(frozen=True)
class Job:
    """One sharded bootstrap for `bootstrap_jobs`.  scheme, ct,
    phase1_keys: .npz paths (a KmsScheme, an Lwe, and None or an
    MxKmsKeys / BmKmsPhase1); scheme and phase1_keys may instead be a tuple
    of one path per rank of the party axis, each file holding that rank's
    `mesh.party_share` (with shard_phase2 for the scheme if the job has
    it); mesh: (n_party, n_batch), n_batch None for a party-only mesh;
    sharded: `kms_bootstrap_sharded` instead of `kms_bootstrap_shardmap`;
    reps: bootstraps run (the output is the first's, time and launches the
    last's); graphed: the last of them is the warm-up of
    `graphs.capture_sharded`, then the graphs replay reps times (output,
    time and launches as for the eager runs)."""

    name: str
    params: object
    scheme: str | tuple
    ct: str
    mesh: tuple
    phase1_keys: str | tuple | None = None
    shard_phase2: bool = False
    sharded: bool = False
    reps: int = 1
    graphed: bool = False


def _launches() -> dict:
    from ..kernels import fused_mx2, fused_mx3, hybrid_product
    from ..kernels import ntt as kntt

    return {
        "fwd": kntt.fwd_ntt_nat.launches, "inv": kntt.inv_ntt_nat.launches,
        "fwd_bm": kntt.fwd_ntt_bm.launches, "inv_bm": kntt.inv_ntt_bm.launches,
        "mx": fused_mx2.mx_sweep.launches, "sweep": fused_mx3.phase1_sweep.launches,
        "hybrid": hybrid_product.hybrid_product.launches,
    }


def _reset_launches() -> None:
    from ..kernels import fused_mx2, fused_mx3, hybrid_product
    from ..kernels import ntt as kntt

    hybrid_product.reset_launches()
    kntt.reset_launches()
    fused_mx2.reset_launches()
    fused_mx3.reset_launches()


def _on(obj, device):
    """A key object's tensors on `device`."""
    if hasattr(obj, "_fields"):
        return type(obj)(*(t.to(device) for t in obj))
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)})


def _bytes(obj) -> int:
    """Bytes of a key dataclass' (or NamedTuple's) tensors."""
    tensors = obj if hasattr(obj, "_fields") else [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return sum(t.numel() * t.element_size() for t in tensors)


def _host_rss_bytes() -> int:
    """This process' resident host memory now (/proc/self/statm; a peak
    counter would not do: `ru_maxrss` keeps the spawning parent's peak
    across a spawned rank's exec, and not every kernel reports `VmHWM`)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _files(job: Job) -> list[str]:
    """Every .npz path a job names."""
    return [path for field in (job.scheme, job.ct, job.phase1_keys) if field is not None
            for path in ((field,) if isinstance(field, str) else field)]


def _timed(fn, reps: int, device: torch.device) -> tuple:
    """fn() run reps times, each from a barrier to its end on the device:
    (the first output, the last's ms, the last's kernel launches)."""
    first, ms = None, 0.0
    for rep in range(reps):
        _reset_launches()
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        if rep == 0:
            first = res
    return first, ms, _launches()


def _replays(graphed, args: tuple, reps: int, device: torch.device) -> dict:
    """`graphed(*args)` replayed as `_timed` runs the eager bootstraps, a
    whole graph's (NCCL) with every synchronizing call an error: its output,
    ms and launches, and the capture's numbers."""
    from ..graphs import without_sync

    def replay():
        return without_sync(graphed, *args) if graphed.whole else graphed(*args)

    got, ms, launches = _timed(replay, reps, device)
    return {"b": got.b, "a": got.a, "ms": ms, "launches": launches, **_graph_record(graphed)}


def _graph_record(graphed) -> dict:
    return {"nodes": graphed.nodes, "segments": len(graphed.graphs), "whole": graphed.whole,
            "capture_s": graphed.capture_s, "instantiate_s": graphed.instantiate_s,
            "pool_bytes": graphed.pool_bytes, "pool_peak_bytes": graphed.pool_peak_bytes}


def bootstrap_jobs(device: torch.device, jobs: list[Job]) -> list[dict]:
    """The rank program: each job's sharded bootstrap on this rank's share
    of the keys.  Per job: the output ("b", "a": the whole batch), the
    kernel launches and the ms of one bootstrap on this rank (from a
    barrier to the output, the device synchronised), the bytes of keys it
    held, the bytes of the files it read for the job (its shares' files, or
    the whole files it cut its share from, and the ciphertext), its
    resident host memory (the larger of two samples: with the job's keys
    loaded, and after its bootstraps), its device memory peak in the job
    (0 on the CPU), and whether jax or the JAX package were imported here.
    A graphed job adds under "graph" the replays' output, ms and launches
    (counted as the eager ones), the capture's numbers (`_graph_record`),
    and where one graph holds the whole program (NCCL) the same program
    captured by segment, its collectives eager ("by_segment": its output,
    nodes and graphs): the nodes the collectives add; a whole graph's
    replays run with every synchronizing call an error
    (`graphs.without_sync`)."""
    from ..graphs import capture_sharded
    from ..utils.serialization import load
    from .mesh import axis, make_mesh, shard_scheme
    from .shardmap import run_program, sharded_program, shardmap_program

    files, meshes, out = {}, {}, []

    def loaded(path):
        if path not in files:
            files[path] = load(path, "cpu")
        return files[path]

    def own(path, mesh):
        """The file this rank reads: the whole file, or its share's."""
        return path if isinstance(path, str) else path[axis(mesh, "party")[0]]

    def share(path, mesh, shard_phase2=False):
        """This rank's share: cut from a whole file, or a file of its own."""
        if isinstance(path, str):
            return shard_scheme(loaded(path), mesh, shard_phase2)
        return loaded(own(path, mesh))

    for index, job in enumerate(jobs):
        if job.mesh not in meshes:
            meshes[job.mesh] = make_mesh(*job.mesh, device.type)
        mesh = meshes[job.mesh]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        scheme = _on(share(job.scheme, mesh, job.shard_phase2), device)
        keys = None if job.phase1_keys is None else _on(share(job.phase1_keys, mesh), device)
        ct = _on(loaded(job.ct), device)
        rss = _host_rss_bytes()
        program, extra = (sharded_program, ()) if job.sharded else (shardmap_program, (keys, job.shard_phase2))

        def eager():
            return run_program(program(scheme, job.params, mesh, ct.b.shape[0], *extra), ct)

        eager_reps = job.reps - job.graphed
        first, ms, launches = _timed(eager, eager_reps, device)
        record, peak = {"name": job.name}, 0
        if job.graphed:
            graphed, _, launches = _timed(
                lambda: capture_sharded(program, ct, scheme, job.params, mesh, *extra), 1, device)
            first = graphed.warmup_out if first is None else first
            ms, peak = graphed.warmup_s * 1e3, graphed.warmup_peak_bytes
            record["graph"] = _replays(graphed, (ct, scheme, job.params, mesh, *extra), job.reps, device)
            del graphed  # its pool goes before the next capture's
            if record["graph"]["whole"]:
                by_segment, _, _ = _timed(lambda: capture_sharded(
                    program, ct, scheme, job.params, mesh, *extra, by_segment=True), 1, device)
                got = by_segment(ct, scheme, job.params, mesh, *extra)
                record["graph"]["by_segment"] = {"b": got.b, "a": got.a, **_graph_record(by_segment)}
                del by_segment
        record.update({
            "b": first.b, "a": first.a, "launches": launches, "ms": ms,
            "key_bytes": _bytes(scheme) + (0 if keys is None else _bytes(keys)),
            "loaded_bytes": sum(_bytes(loaded(own(path, mesh))) for path in (job.scheme, job.phase1_keys, job.ct)
                                if path is not None),
            "host_rss_bytes": max(rss, _host_rss_bytes()),
            "device_peak_bytes": max(peak, torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0,
            "jax": "jax" in sys.modules, "mktfhe_tpu": "mktfhe_tpu" in sys.modules,
        })
        out.append(record)
        del scheme, keys
        later = {path for j in jobs[index + 1 :] for path in _files(j)}
        for path in [path for path in files if path not in later]:  # read by no later job
            del files[path]
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    """Keygen on the card for a KMS preset, one bootstrap of a NAND batch in
    this process, and the same batch through `kms_bootstrap_shardmap` in
    `--world` ranks on a (world, 1) mesh, eagerly and replayed from the
    rank's captured graphs: the outputs must agree bit for bit."""
    from ..schemes import kms
    from ..schemes.gates import GATE_IDS, gate_affine, lwe_ith_encrypt_bit
    from ..schemes.presets import ALL_PRESETS
    from ..utils.serialization import save

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--preset", default="TinyKMS2party")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    params = ALL_PRESETS[args.preset]
    if not isinstance(params, (kms.KmsParams, kms.KmsBlockParams)):
        print(f"{args.preset} is no KMS preset", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false; pass --device cpu", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(MAIN_SEED)
    a = kms.crs(gen, params)
    parties = [kms.party_keygen(gen, a, params) for _ in range(params.k)]
    scheme = kms.setup(a, [p[3] for p in parties], params)
    rng = np.random.default_rng(MAIN_SEED)
    m = [torch.from_numpy(rng.integers(0, 2, MAIN_BATCH).astype(bool)).to(device) for _ in range(2)]
    cts = [lwe_ith_encrypt_bit(gen, m[i], i, parties[i][0], params.alpha, params.k, (MAIN_BATCH,)) for i in range(2)]
    ct = gate_affine(GATE_IDS["NAND"], *cts)
    want = kms.bootstrap(ct, scheme, params)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{name}.npz") for name in ("scheme", "ct")]
        save(paths[0], scheme)
        save(paths[1], ct)
        job = Job("shardmap", params, *paths, mesh=(args.world, 1), graphed=True)
        ranks = run_ranks(bootstrap_jobs, args.world, args.backend, ([job],), args.device)
    for rank, (res,) in enumerate(ranks):
        graph = res["graph"]
        same = all(np.array_equal(out["b"], to_numpy(want.b)) and np.array_equal(out["a"], to_numpy(want.a))
                   for out in (res, graph))
        print(f"rank {rank}: eager and graphed {'==' if same else '!='} kms.bootstrap; one cold bootstrap "
              f"{res['ms']:.1f} ms, a replay {graph['ms']:.1f} ms ({graph['segments']} graphs, {graph['nodes']} "
              f"nodes), launches {res['launches']} eager, {graph['launches']} a replay")
        if not same or graph["launches"] != res["launches"]:
            return 1
    print("OK")
    return 0
