"""Party-sharded phase 1, gate-split phase 2, with the collectives written
out: port of mktfhe_tpu/parallel/shardmap.py over torch.distributed.

What `jax.shard_map` expressed over a device mesh is here one program that
every rank runs on its own slices (`launch.run_ranks` starts the ranks):

  * phase 1: each rank runs its resident parties (k / n_party of them) on
    its batch shard, with no communication.  Engine by `phase1_keys`: None
    the reference engine (`kms.phase1` / `phase1_block`, the NTT kernel
    under it), an MxKmsKeys the mx sweep kernel, a BmKmsPhase1 the
    batch-minor engine.  Every party runs l_lev RLEV rows, party 1 too, so
    that the all-gather sees equal shapes on every rank; phase 2 reads row
    0 of party 1's.  Rows never mix, so this is bit-identical to the
    single-device run of party 1 with one row;
  * phase boundary: one all_gather of the lev keys over the party axis;
  * phase 2 and the key switch: the ranks of the party axis split the
    local gates between them when they divide (rank p takes gates
    [p*Gs, (p+1)*Gs)), else each runs all of them; all_gathers over the
    party axis, then over the batch axis, reassemble the batch.  Every
    rank returns the whole Lwe.

With shard_phase2 the phase-2 keys (rlk, pub_b, ksk) stay party-sharded too
(the k = 32 residency plan, PARALLEL.md): at each merge the owner
broadcasts its party's rlk rows (the torch idiom for the JAX package's
masked psum), the public keys are all-gathered once, and the key switch runs
party-partial: the parties' shares of b are summed in int64 across the
party axis and then wrapped mod 2^32, their a segments all-gathered along
the mask.

The program is a list of steps (`program`): segments, plain functions on
the rank's tensors that communicate nothing, and the collectives between
them.  `run_program` runs the steps in order: that is the eager bootstrap.
`graphs.capture_sharded` captures the same steps, the port's counterpart of
the JAX package's `jax.jit` over `shard_map`: over NCCL the whole list,
collectives included, as one CUDA graph; over gloo, whose collectives stage
through the host and cannot be captured, one graph a segment, the
collectives run between the replays from and into the segments' buffers.

Bit-identical to the single-device path for every engine
(tests/test_torch_parallel*.py).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ciphertext.lwe import Lwe
from ..ring.torus import wrap_i32
from ..schemes import kms
from ..schemes.common import initial_acc, keyswitch_parties, mod_switch_2n
from ..schemes.params import KmsBlockParams
from ..utils.profiling import phase_range
from .mesh import PHASE2_FIELDS, _issued, all_reduce, axis, gather, resident


@dataclasses.dataclass(frozen=True)
class Segment:
    """Work between two collectives: fn(state) -> the entries it adds to
    the state (name -> tensor).  It communicates nothing, so a CUDA graph
    can hold it whatever the backend."""

    fn: Callable[[dict], dict]


@dataclasses.dataclass(frozen=True)
class Collective:
    """A collective between segments: fn(state, out) -> the tensor stored
    under `name`, written into `out` when it is given (a graph's replay
    reads it there), else into a new tensor."""

    name: str
    fn: Callable[[dict, torch.Tensor | None], torch.Tensor]


def run_steps(steps: list, state: dict) -> dict:
    """The steps in order on `state` (name -> tensor); returns the state
    after the last."""
    state = dict(state)
    for step in steps:
        if isinstance(step, Collective):
            state[step.name] = step.fn(state, None)
        else:
            state.update(step.fn(state))
    return state


def program_input(ct: Lwe) -> dict:
    return {"b": ct.b, "a": ct.a}


def program_output(state: dict) -> Lwe:
    """The whole batch's Lwe from the state after the last step: the
    gathers over the batch axis, [n_batch, Gl] and [n_batch, Gl, k*n],
    viewed as one batch."""
    return Lwe(b=state["b_batch"].flatten(0, 1), a=state["a_batch"].flatten(0, 1))


def run_program(steps: list, ct: Lwe) -> Lwe:
    """The eager bootstrap: `program`'s steps run in order on ct."""
    return program_output(run_steps(steps, program_input(ct)))


def _engine(scheme: kms.KmsScheme, phase1_keys, k: int, mesh: DeviceMesh):
    """(engine name, scheme, phase-1 keys) with the phase-1 keys cut to
    this rank's parties."""
    engine = kms.phase1_engine(phase1_keys)
    if engine == "ref":
        kms.require_brk(scheme, "the reference phase-1 engine")
        return engine, dataclasses.replace(scheme, brk_hat=resident(scheme.brk_hat, k, mesh)), None
    name = "brk_mx" if engine == "mx2" else "brk_bm"
    return engine, scheme, dataclasses.replace(phase1_keys, **{name: resident(getattr(phase1_keys, name), k, mesh)})


def _bcast(x_l: torch.Tensor, party: int, kp: int, mesh: DeviceMesh, out: torch.Tensor | None) -> torch.Tensor:
    """Party `party`'s slice of a party-sharded tensor, broadcast from the
    rank of the party axis that holds it (there the slice itself; on the
    others `out`, or a new tensor)."""
    owner, li = divmod(party, kp)
    pidx, _ = axis(mesh, "party")
    if pidx == owner:
        t = x_l[li].contiguous()
    else:
        t = torch.empty_like(x_l[0]) if out is None else out
    if _issued(mesh, "party"):
        group = mesh.get_group("party")  # its ranks in the order of the party axis
        dist.broadcast(t, src=dist.get_global_rank(group, owner), group=group)
    return t


def _gather_step(name: str, src, axis_name: str, mesh: DeviceMesh) -> Collective:
    """A Collective storing under `name` the gather over `axis_name` of
    src(state)."""
    return Collective(name, lambda s, out: gather(src(s), mesh, axis_name, out))


def _whole(state: dict, name: str) -> torch.Tensor:
    return state[name]


def _phase2_steps(scheme, params, ctx, mesh: DeviceMesh, gl: int, split_gates: bool) -> tuple[list, Callable]:
    """Phase 2 and the key switch on whole phase-2 keys: the ranks of the
    party axis split the gl local gates between them when they divide
    (rank p takes gates [p*Gs, (p+1)*Gs)) and gather the parts, else each
    runs all of them.  Returns the steps and local(state, name): the rank's
    output "b" or "a" over its gl gates after them."""
    k = params.k
    pidx, n_party = axis(mesh, "party")
    split = split_gates and n_party > 1 and gl % n_party == 0
    gs = gl // n_party if split else gl

    def phase2(s):
        lev, tb = s["lev"].flatten(0, 1), s["tb"]  # [k, Gl, l_lev, 2, npr, N], [Gl]
        if split:
            lev, tb = lev[:, pidx * gs : (pidx + 1) * gs], tb[pidx * gs : (pidx + 1) * gs]
        acc = initial_acc(tb, params.big_n, k, ctx.dtype)
        for p1 in range(1, k + 1):
            with phase_range(f"mktfhe/phase2/merge{p1}"):
                acc = kms._phase2_party(acc, lev[p1 - 1][:, : 1 if p1 == 1 else params.l_lev], p1,
                                        scheme, params, ctx)
        with phase_range("mktfhe/keyswitch"):
            out = kms._keyswitch(acc, scheme, params)
        return {"b": out.b, "a": out.a}

    if not split:
        return [Segment(phase2)], _whole
    gathers = [_gather_step(f"{name}_parts", lambda s, name=name: s[name], "party", mesh) for name in ("b", "a")]
    return [Segment(phase2), *gathers], lambda s, name: s[f"{name}_parts"].flatten(0, 1)


def _phase2_sharded_steps(scheme, params, ctx, mesh: DeviceMesh) -> tuple[list, Callable]:
    """Phase 2 and the key switch with the phase-2 keys party-sharded: the
    public keys gathered once, each merge's rlk rows broadcast by their
    owner before it, the key switch party-partial (b's shares summed in
    int64 over the party axis, then wrapped; a's segments gathered along
    the mask).  Returns the steps and local(state, name) as
    `_phase2_steps`."""
    k = params.k
    pidx, n_party = axis(mesh, "party")
    kp = k // n_party
    rd, rf = resident(scheme.rlk_d_hat, k, mesh), resident(scheme.rlk_f_hat, k, mesh)
    pub = resident(scheme.pub_b_hat, k, mesh)
    ksk_b, ksk_a = resident(scheme.ksk_b, k, mesh), resident(scheme.ksk_a, k, mesh)

    def merge(p1: int, s):
        acc = initial_acc(s["tb"], params.big_n, k, ctx.dtype) if p1 == 1 else s["acc"]
        rows = 1 if p1 == 1 else params.l_lev
        with phase_range(f"mktfhe/phase2/merge{p1}"):
            acc = kms._phase2_party_mat(acc, s["lev"].flatten(0, 1)[p1 - 1][:, :rows], p1, s["rd"], s["rf"],
                                        s["pub"].flatten(0, 1)[: p1 - 1], scheme.crs_hat, params, ctx)
        return {"acc": acc}

    def keyswitch(s):
        with phase_range("mktfhe/keyswitch"):
            acc32 = (s["acc"] >> 32).to(torch.int32)  # modulus switch 2^64 -> 2^32
            share, a = keyswitch_parties(acc32[:, 1 + pidx * kp : 1 + (pidx + 1) * kp], ksk_b, ksk_a,
                                         params.f, params.log_d)
        return {"b0": acc32[:, 0, 0], "share": share, "a_part": a}

    def assemble(s):
        a = s["a_parts"]  # [n_party, G, kp*n]: the parties' segments in order
        return {"b": wrap_i32(s["b0"].long() + s["share"]), "a": a.movedim(0, 1).reshape(a.shape[1], -1)}

    # later merges need every earlier party's public key: gathered once
    steps = [Collective("pub", lambda s, out: gather(pub, mesh, "party", out))]
    for p1 in range(1, k + 1):
        steps += [
            Collective("rd", lambda s, out, p1=p1: _bcast(rd, p1 - 1, kp, mesh, out)),
            Collective("rf", lambda s, out, p1=p1: _bcast(rf, p1 - 1, kp, mesh, out)),
            Segment(lambda s, p1=p1: merge(p1, s)),
        ]
    return steps + [
        Segment(keyswitch),
        Collective("share", lambda s, out: all_reduce(s["share"], mesh, "party")),  # int64: summed, then wrapped
        Collective("a_parts", lambda s, out: gather(s["a_part"], mesh, "party", out)),
        Segment(assemble),
    ], _whole


def program(scheme: kms.KmsScheme, params, mesh: DeviceMesh, gates: int, phase1_keys,
            split_gates: bool, shard_phase2: bool) -> list:
    """The steps every rank runs for a batch of `gates` gates (see the
    module docstring): one segment of mod switch and phase 1 of the
    resident parties, the gather of their lev keys over the party axis,
    phase 2 and the key switch, and the gathers over the batch axis.  Keys
    and arguments that do not fit together are refused here, before any
    collective."""
    ctx = kms._ctx(params)
    k = params.k
    pidx, n_party = axis(mesh, "party")
    bidx, n_batch = axis(mesh, "batch")
    if k % n_party:
        raise ValueError(f"{k} parties do not divide over {n_party} ranks of the party axis")
    if shard_phase2 and isinstance(params, KmsBlockParams):
        raise TypeError("shard_phase2 serves binary-key presets (the party-partial key switch has no free head)")
    if not shard_phase2:
        cut = [name for name in PHASE2_FIELDS if getattr(scheme, name).shape[0] != k]
        if cut:
            raise ValueError(f"the scheme's phase-2 keys {cut} do not hold all {k} parties (a scheme cut by "
                             f"shard_scheme(..., shard_phase2=True)): pass shard_phase2=True")
    if gates % n_batch:
        raise ValueError(f"{gates} gates do not divide over {n_batch} ranks of the batch axis")
    kp = k // n_party
    gl = gates // n_batch
    engine, scheme, keys = _engine(scheme, phase1_keys, k, mesh)

    def phase1(s):
        with phase_range("mktfhe/mod_switch"):
            tildeb, tildea = mod_switch_2n(Lwe(b=s["b"], a=s["a"]), params.big_n)
        ta = tildea[bidx * gl : (bidx + 1) * gl].reshape(gl, k, params.n)
        local = []
        for i in range(kp):
            party = pidx * kp + i
            with phase_range(f"mktfhe/phase1/party{party}"):
                local.append(kms.phase1_levkey(engine, i, ta[:, party].contiguous(), params.l_lev,
                                               scheme, params, ctx, keys))
        return {"tb": tildeb[bidx * gl : (bidx + 1) * gl], "local": torch.stack(local)}  # [kp, Gl, l_lev, 2, npr, N]

    if shard_phase2:
        phase2, local = _phase2_sharded_steps(scheme, params, ctx, mesh)
    else:
        phase2, local = _phase2_steps(scheme, params, ctx, mesh, gl, split_gates)
    return [
        Segment(phase1),
        Collective("lev", lambda s, out: gather(s["local"], mesh, "party", out)),
        *phase2,
        *(_gather_step(f"{name}_batch", lambda s, name=name: local(s, name), "batch", mesh) for name in ("b", "a")),
    ]


def shardmap_program(scheme: kms.KmsScheme, params, mesh: DeviceMesh, gates: int, phase1_keys=None,
                     shard_phase2: bool = False) -> list:
    """`kms_bootstrap_shardmap`'s steps for a batch of `gates` gates."""
    return program(scheme, params, mesh, gates, phase1_keys, split_gates=True, shard_phase2=shard_phase2)


def sharded_program(scheme: kms.KmsScheme, params, mesh: DeviceMesh, gates: int) -> list:
    """`mesh.kms_bootstrap_sharded`'s steps: the reference engine, phase 2
    replicated along the party axis, its gates not split."""
    return program(scheme, params, mesh, gates, None, split_gates=False, shard_phase2=False)


def kms_bootstrap_shardmap(ct: Lwe, scheme: kms.KmsScheme, params, mesh: DeviceMesh, phase1_keys=None,
                           shard_phase2: bool = False) -> Lwe:
    """KMS gate bootstrap over a (party, batch) mesh (or a party-only one)
    with the collectives written out; every rank of the mesh calls it.

    ct: the whole gate batch, on every rank; scheme: the KmsScheme, whole
    or as `shard_scheme(scheme, mesh, shard_phase2)` leaves it (the phase-1
    keys, and with shard_phase2 the phase-2 keys, of this rank's parties;
    phase-2 keys cut so are refused without shard_phase2);
    phase1_keys: None (the reference engine on `scheme.brk_hat`), an
    MxKmsKeys (the mx sweep kernel) or a BmKmsPhase1 (the batch-minor
    engine), whole or sharded likewise.  The party axis must divide k, the
    batch axis the gates.  Returns the whole Lwe on every rank,
    bit-identical to `kms.bootstrap`."""
    return run_program(shardmap_program(scheme, params, mesh, ct.b.shape[0], phase1_keys, shard_phase2), ct)
