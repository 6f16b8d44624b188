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

Bit-identical to the single-device path for every engine
(tests/test_torch_parallel*.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.profiler import record_function

from ..ciphertext.lwe import Lwe
from ..ring.torus import wrap_i32
from ..schemes import kms
from ..schemes.common import initial_acc, keyswitch_parties, mod_switch_2n
from ..schemes.params import KmsBlockParams
from .mesh import PHASE2_FIELDS, all_gather, axis, resident


def _engine(scheme: kms.KmsScheme, phase1_keys, k: int, mesh: DeviceMesh):
    """(engine name, scheme, phase-1 keys) with the phase-1 keys cut to
    this rank's parties."""
    engine = kms.phase1_engine(phase1_keys)
    if engine == "ref":
        kms.require_brk(scheme, "the reference phase-1 engine")
        return engine, dataclasses.replace(scheme, brk_hat=resident(scheme.brk_hat, k, mesh)), None
    name = "brk_mx" if engine == "mx2" else "brk_bm"
    return engine, scheme, dataclasses.replace(phase1_keys, **{name: resident(getattr(phase1_keys, name), k, mesh)})


def _bcast(x_l: torch.Tensor, party: int, kp: int, mesh: DeviceMesh) -> torch.Tensor:
    """Party `party`'s slice of a party-sharded tensor, broadcast from the
    rank of the party axis that holds it."""
    owner, li = divmod(party, kp)
    pidx, _ = axis(mesh, "party")
    t = x_l[li].contiguous() if pidx == owner else torch.empty_like(x_l[0])
    group = mesh.get_group("party")  # its ranks in the order of the party axis
    dist.broadcast(t, src=dist.get_global_rank(group, owner), group=group)
    return t


def _phase2_sharded(acc, lev, scheme, params, ctx, mesh: DeviceMesh) -> Lwe:
    """Phase 2 and the key switch with the phase-2 keys party-sharded."""
    k = params.k
    pidx, n_party = axis(mesh, "party")
    kp = k // n_party
    rd, rf = resident(scheme.rlk_d_hat, k, mesh), resident(scheme.rlk_f_hat, k, mesh)
    # later merges need every earlier party's public key: gathered once
    pub = all_gather(resident(scheme.pub_b_hat, k, mesh), mesh, "party")
    for p1 in range(1, k + 1):
        with record_function(f"mktfhe/phase2/merge{p1}"):
            rows = 1 if p1 == 1 else params.l_lev
            acc = kms._phase2_party_mat(
                acc, lev[p1 - 1][:, :rows], p1, _bcast(rd, p1 - 1, kp, mesh), _bcast(rf, p1 - 1, kp, mesh),
                pub[: p1 - 1], scheme.crs_hat, params, ctx,
            )
    with record_function("mktfhe/keyswitch"):
        acc32 = (acc >> 32).to(torch.int32)  # modulus switch 2^64 -> 2^32
        share, a = keyswitch_parties(
            acc32[:, 1 + pidx * kp : 1 + (pidx + 1) * kp],
            resident(scheme.ksk_b, k, mesh), resident(scheme.ksk_a, k, mesh), params.f, params.log_d,
        )
        dist.all_reduce(share, group=mesh.get_group("party"))  # int64: summed, then wrapped
        return Lwe(b=wrap_i32(acc32[:, 0, 0].long() + share), a=all_gather(a, mesh, "party", dim=1))


def bootstrap_program(ct: Lwe, scheme: kms.KmsScheme, params, mesh: DeviceMesh, phase1_keys,
                      split_gates: bool, shard_phase2: bool) -> Lwe:
    """The program every rank runs (see the module docstring)."""
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
    kp = k // n_party
    engine, scheme, keys = _engine(scheme, phase1_keys, k, mesh)

    with record_function("mktfhe/mod_switch"):
        tildeb, tildea = mod_switch_2n(ct, params.big_n)
    g = tildeb.shape[0]
    if g % n_batch:
        raise ValueError(f"{g} gates do not divide over {n_batch} ranks of the batch axis")
    gl = g // n_batch
    tb = tildeb[bidx * gl : (bidx + 1) * gl]
    ta = tildea[bidx * gl : (bidx + 1) * gl].reshape(gl, k, params.n)

    local = []
    for i in range(kp):
        party = pidx * kp + i
        with record_function(f"mktfhe/phase1/party{party}"):
            local.append(kms.phase1_levkey(engine, i, ta[:, party].contiguous(), params.l_lev,
                                           scheme, params, ctx, keys))
    lev = all_gather(torch.stack(local), mesh, "party")  # [k, Gl, l_lev, 2, npr, N]

    if shard_phase2:
        out = _phase2_sharded(initial_acc(tb, params.big_n, k, ctx.dtype), lev, scheme, params, ctx, mesh)
    else:
        split = split_gates and n_party > 1 and gl % n_party == 0
        if split:
            gs = gl // n_party
            lev, tb = lev[:, pidx * gs : (pidx + 1) * gs], tb[pidx * gs : (pidx + 1) * gs]
        acc = initial_acc(tb, params.big_n, k, ctx.dtype)
        for p1 in range(1, k + 1):
            with record_function(f"mktfhe/phase2/merge{p1}"):
                acc = kms._phase2_party(acc, lev[p1 - 1][:, : 1 if p1 == 1 else params.l_lev], p1,
                                        scheme, params, ctx)
        with record_function("mktfhe/keyswitch"):
            out = kms._keyswitch(acc, scheme, params)
        if split:
            out = Lwe(b=all_gather(out.b, mesh, "party"), a=all_gather(out.a, mesh, "party"))
    return Lwe(b=all_gather(out.b, mesh, "batch"), a=all_gather(out.a, mesh, "batch"))


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
    return bootstrap_program(ct, scheme, params, mesh, phase1_keys, split_gates=True, shard_phase2=shard_phase2)
