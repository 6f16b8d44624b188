"""The party-sharded bootstrap as segments and collectives
(mktfhe_tpu_torch/parallel/shardmap.py) and its capture
(`graphs.capture_sharded`), on the CPU.

The rank's program is a list of steps: segments, which communicate nothing,
and the collectives between them; the eager bootstrap runs them in order,
and a graphed one replays the segments' graphs with the collectives between
them.  Here, on the JAX package's keys at TinyKMS2partyMX (its MxKmsKeys and
BmKmsPhase1 too), against the JAX `kms.bootstrap` (tolerance 0):

  * two ranks of this process, each a thread (a stand-in for two gloo
    ranks, their collectives exchanged in memory), run the steps in order
    with every collective forbidden inside a segment, for the reference,
    mx2 and batch-minor engines, with and without shard_phase2, and for
    `kms_bootstrap_sharded`; then again on another batch with every
    collective writing into the buffer it made the first time, as a gloo
    rank's replay does;
  * two gloo ranks spawned by `launch.run_ranks` run `bootstrap_jobs`'
    graphed jobs: on the CPU `capture_sharded` gives an object that runs
    the eager program, and its output equals the eager one;
  * in a one-rank gloo group of this process: that object refuses another
    batch, scheme, keys, parameters or mesh, and the sharded bootstrap
    opens the named phase ranges that `kms.bootstrap` opens, in order.

The graphs themselves: tests/test_torch_cuda.py, marker `cuda`.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mktfhe_tpu.kernels.batchminor import build_bm_kms_phase1 as j_build_bm
from mktfhe_tpu.kernels.fused_mx2 import build_mx_kms_keys as j_build_mx
from mktfhe_tpu.schemes import kms as jkms
from mktfhe_tpu.schemes.gates import gate_affine as j_gate_affine
from mktfhe_tpu.schemes.gates import lwe_ith_encrypt_bit as j_encrypt
from mktfhe_tpu.schemes.presets import TEST_PRESETS
from mktfhe_tpu_torch import bridge
from mktfhe_tpu_torch.ciphertext.lwe import Lwe
from mktfhe_tpu_torch.graphs import capture_sharded
from mktfhe_tpu_torch.parallel import shardmap
from mktfhe_tpu_torch.parallel.launch import Job, bootstrap_jobs, run_ranks
from mktfhe_tpu_torch.parallel.mesh import make_mesh
from mktfhe_tpu_torch.utils import profiling

from test_torch_parallel import save_all

CPU = torch.device("cpu")
PARAMS = TEST_PRESETS["TinyKMS2partyMX"]
TPARAMS = bridge.params(PARAMS)
GATES = 4  # 2 a rank of the gate split at party 2


def _batch(a, lwe_keys, seed: int):
    """A NAND batch of GATES gates of party 0's m and party 1's ~m."""
    m = jnp.asarray(np.random.default_rng(seed).integers(0, 2, GATES).astype(bool))
    return j_gate_affine(0, j_encrypt(jax.random.key(seed), m, 0, lwe_keys[0], PARAMS.alpha, PARAMS.k, (GATES,)),
                         j_encrypt(jax.random.key(seed + 1), ~m, 1, lwe_keys[1], PARAMS.alpha, PARAMS.k, (GATES,)))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's keys, two batches and their `kms.bootstrap`; the
    port's scheme, MxKmsKeys and BmKmsPhase1 bridged from them."""
    a = jkms.crs(jax.random.key(0), PARAMS)
    parties = [jkms.party_keygen(jax.random.key(1 + i), a, PARAMS) for i in range(PARAMS.k)]
    scheme = jkms.setup(a, [p[3] for p in parties], PARAMS)
    cts = [_batch(a, [p[0] for p in parties], seed) for seed in (91, 93)]
    boot = jax.jit(lambda ct: jkms.bootstrap(ct, scheme, PARAMS))
    keys = {"mx2": j_build_mx([p[3] for p in parties], PARAMS), "bm": j_build_bm([p[3] for p in parties], PARAMS)}
    return {
        "jscheme": scheme, "jcts": cts, "jkeys": keys, "want": [boot(ct) for ct in cts],
        "scheme": bridge.kms_scheme(scheme, CPU), "cts": [bridge.lwe(ct, CPU) for ct in cts],
        "keys": {"ref": None, "mx2": bridge.mx_kms_keys(keys["mx2"], CPU),
                 "bm": bridge.bm_kms_phase1(keys["bm"], CPU)},
    }


def _equal(got, want) -> None:
    """got (an Lwe of the port, or a rank's result: numpy "b" and "a") ==
    want (the JAX package's Lwe)."""
    b, a = (got["b"], got["a"]) if isinstance(got, dict) else (bridge.to_numpy(got.b), bridge.to_numpy(got.a))
    np.testing.assert_array_equal(b, np.asarray(want.b))
    np.testing.assert_array_equal(a, np.asarray(want.a))


# --- two ranks as threads of this process -------------------------------------


class _Mesh:
    """A (party 2, batch 1) mesh as rank `pidx` sees it: what
    parallel/mesh.py reads of a DeviceMesh."""

    mesh_dim_names = ("party", "batch")

    def __init__(self, pidx: int):
        self.pidx = pidx

    def get_local_rank(self, name: str) -> int:
        return self.pidx if name == "party" else 0

    def size(self, dim: int) -> int:
        return (2, 1)[dim]

    def get_group(self, name: str) -> str:
        return name


class _Exchange:
    """torch.distributed's collectives for two ranks that are threads of
    this process, on a gloo-like group; a collective called inside a
    segment raises."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=60)
        self.slots = [None, None]
        self.local = threading.local()

    def _swap(self, x: torch.Tensor) -> list:
        if getattr(self.local, "in_segment", False):
            raise AssertionError("a segment called a collective")
        self.slots[self.local.rank] = x.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_gather(self, outs, x, group=None):
        for out, part in zip(outs, self._swap(x)):
            out.copy_(part)

    def broadcast(self, t, src, group=None):
        t.copy_(self._swap(t)[src])

    def all_reduce(self, t, group=None):
        t.copy_(sum(self._swap(t)))

    def patch(self, monkeypatch):
        for name in ("all_gather", "broadcast", "all_reduce"):
            monkeypatch.setattr(dist, name, getattr(self, name))
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
        monkeypatch.setattr(dist, "get_global_rank", lambda group, rank: rank)


def _run(exchange, steps, ct, buffers: dict) -> Lwe:
    """The steps in order, a collective writing into buffers[i] where an
    earlier run left one there (as a gloo replay writes into the buffers of
    its capture), else recording the buffer it made; the output copied out
    of them (a later run writes them again)."""
    state = shardmap.program_input(ct)
    for i, step in enumerate(steps):
        if isinstance(step, shardmap.Collective):
            state[step.name] = step.fn(state, buffers.get(i))
            buffers.setdefault(i, state[step.name])
        else:
            exchange.local.in_segment = True
            try:
                state.update(step.fn(state))
            finally:
                exchange.local.in_segment = False
    out = shardmap.program_output(state)
    return Lwe(b=out.b.clone(), a=out.a.clone())


ENGINES = {
    "ref": dict(engine="ref"),
    "ref_shard_phase2": dict(engine="ref", shard_phase2=True),
    "mx2": dict(engine="mx2"),
    "mx2_shard_phase2": dict(engine="mx2", shard_phase2=True),
    "bm": dict(engine="bm"),
    "bm_shard_phase2": dict(engine="bm", shard_phase2=True),
    "kms_bootstrap_sharded": dict(engine="ref", sharded=True),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_segments_in_order_equal_jax(ref, monkeypatch, name):
    """Two ranks (threads) run the steps of `kms_bootstrap_shardmap` /
    `kms_bootstrap_sharded` in order, no segment communicating: every rank's
    output == the JAX kms.bootstrap; then on the second batch with the
    first run's collective buffers: == again."""
    case = ENGINES[name]
    exchange = _Exchange()
    exchange.patch(monkeypatch)
    keys = ref["keys"][case["engine"]]
    out, errors = [[None, None], [None, None]], []

    def rank(pidx: int):
        try:
            exchange.local.rank = pidx
            mesh = _Mesh(pidx)
            if case.get("sharded"):
                steps = shardmap.sharded_program(ref["scheme"], TPARAMS, mesh, GATES)
            else:
                steps = shardmap.shardmap_program(ref["scheme"], TPARAMS, mesh, GATES, keys,
                                                  case.get("shard_phase2", False))
            buffers = {}
            for run, ct in enumerate(ref["cts"]):
                out[run][pidx] = _run(exchange, steps, ct, buffers)
        except BaseException as err:  # reported by the test's thread
            errors.append(err)
            exchange.barrier.abort()

    threads = [threading.Thread(target=rank, args=(pidx,)) for pidx in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for run, want in enumerate(ref["want"]):
        for got in out[run]:
            _equal(got, want)


# --- two gloo ranks spawned, the rank program's graphed jobs ------------------


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    paths = save_all(tmp_path_factory.mktemp("graphs"), scheme=ref["jscheme"], ct=ref["jcts"][0],
                     mx=ref["jkeys"]["mx2"], bm=ref["jkeys"]["bm"])
    jobs = [
        Job("ref", TPARAMS, paths["scheme"], paths["ct"], mesh=(2, 1), graphed=True),
        Job("mx2 shard_phase2", TPARAMS, paths["scheme"], paths["ct"], mesh=(2, 1), phase1_keys=paths["mx"],
            shard_phase2=True, graphed=True, reps=2),
        Job("bm", TPARAMS, paths["scheme"], paths["ct"], mesh=(2, 1), phase1_keys=paths["bm"], graphed=True),
        Job("kms_bootstrap_sharded", TPARAMS, paths["scheme"], paths["ct"], mesh=(2, 1), sharded=True,
            graphed=True),
    ]
    return jobs, run_ranks(bootstrap_jobs, 2, "gloo", (jobs,), "cpu")


@pytest.mark.parametrize("index", range(4), ids=["ref", "mx2_shard_phase2", "bm", "kms_bootstrap_sharded"])
def test_graphed_jobs_on_cpu_equal_eager(ref, ranks, index):
    """A graphed job on CPU ranks: the eager output (the capture's warm-up)
    and the CPU object's == the JAX kms.bootstrap; no graph, no launch."""
    jobs, results = ranks
    for rank, res in enumerate(r[index] for r in results):
        assert res["name"] == jobs[index].name
        _equal(res, ref["want"][0])
        _equal(res["graph"], ref["want"][0])
        assert res["graph"]["segments"] == res["graph"]["nodes"] == 0 and not res["graph"]["whole"]
        assert res["graph"]["launches"] == res["launches"] and not any(res["launches"].values())
        assert not res["jax"] and not res["mktfhe_tpu"], f"rank {rank} imported jax"


# --- one rank of gloo in this process ------------------------------------------


@pytest.fixture
def mesh(tmp_path):
    """A (party 1, batch 1) mesh over a one-rank gloo group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        yield make_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


def test_capture_on_cpu_refuses_what_it_does_not_hold(ref, mesh, tmp_path):
    """The CPU object of `capture_sharded` runs the eager program (== the JAX
    kms.bootstrap, on the example and on another batch of its shape) and
    refuses another batch, scheme, keys, parameters or mesh."""
    scheme, ct, keys = ref["scheme"], ref["cts"][0], ref["keys"]["mx2"]
    graphed = capture_sharded(shardmap.shardmap_program, ct, scheme, TPARAMS, mesh, keys, True)
    assert not graphed.graphs and graphed.launches == {}
    _equal(graphed.warmup_out, ref["want"][0])
    _equal(graphed(ct, scheme, TPARAMS, mesh, keys, True), ref["want"][0])
    _equal(graphed(ref["cts"][1], scheme, TPARAMS, mesh, keys, True), ref["want"][1])
    other_mesh = make_mesh(1, 1, "cpu")
    refused = {
        "batch": (Lwe(b=ct.b[:-1], a=ct.a[:-1]), scheme, (TPARAMS, mesh, keys, True)),
        "scheme": (ct, dataclasses.replace(scheme), (TPARAMS, mesh, keys, True)),
        "keys": (ct, scheme, (TPARAMS, mesh, dataclasses.replace(keys), True)),
        "params": (ct, scheme, (dataclasses.replace(TPARAMS), mesh, keys, True)),
        "mesh": (ct, scheme, (TPARAMS, other_mesh, keys, True)),
        "shard_phase2": (ct, scheme, (TPARAMS, mesh, keys, False)),
    }
    for what, (x, s, rest) in refused.items():
        with pytest.raises(ValueError):
            graphed(x, s, *rest)


@pytest.mark.parametrize("shard_phase2", [False, True], ids=["replicated", "shard_phase2"])
def test_sharded_ranges_are_the_bootstraps(ref, mesh, shard_phase2, tmp_path):
    """The sharded bootstrap opens the named phase ranges (`phase_range`)
    that the single-process `kms.bootstrap` opens, in the same order."""
    from mktfhe_tpu_torch.schemes import kms

    def names(run) -> list[str]:
        with profiling.trace(str(tmp_path)) as prof:
            run()
        events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                        if e.is_user_annotation() and e.name().startswith(profiling.PREFIX))
        return [name for _, name in events]

    scheme, ct = ref["scheme"], ref["cts"][0]
    want = ["mktfhe/mod_switch"]
    for party in range(PARAMS.k):
        want += [f"mktfhe/phase1/party{party}", "mktfhe/levkey_lift"]
    for p1 in range(1, PARAMS.k + 1):
        want += [f"mktfhe/phase2/merge{p1}", "mktfhe/phase2/hybrid"]
    want += ["mktfhe/keyswitch"]
    assert names(lambda: kms.bootstrap(ct, scheme, TPARAMS)) == want
    assert names(lambda: shardmap.kms_bootstrap_shardmap(ct, scheme, TPARAMS, mesh, shard_phase2=shard_phase2)) == want
