"""Multi-device sharding of the multi-key bootstrap over torch.distributed.

Port of mktfhe_tpu/parallel/mesh.py.  A (party, batch) device mesh: each
party's phase-1 key resident on its own rank group (phase 1 needs no
communication, the scheme's structural gift), and a batch axis for
gate-level data parallelism.  One process a rank (`launch.run_ranks`);
every rank runs the same program on its own slices.

The JAX package let XLA's SPMD partitioner insert the collectives
(`jax.sharding`); PyTorch has no such partitioner, so the collectives are
written out (`shardmap.py`) and `kms_bootstrap_sharded` is that program
with the phase-2 gate split over the party axis turned off.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ciphertext.lwe import Lwe
from ..kernels.batchminor import BmKmsPhase1
from ..kernels.fused_mx2 import MxKmsKeys
from ..schemes.kms import KmsScheme

# per-party key material of a KmsScheme: phase 1's, and phase 2's and the
# key switch's (resident only with shard_phase2)
PHASE1_FIELDS = ("brk_hat",)
PHASE2_FIELDS = ("pub_b_hat", "rlk_d_hat", "rlk_f_hat", "ksk_b", "ksk_a")


def make_mesh(n_party: int, n_batch: int | None, device_type: str) -> DeviceMesh:
    """A ("party", "batch") mesh over the process group's ranks, rank
    p * n_batch + b at (p, b) as in the JAX package; n_batch=None gives a
    party-only mesh.  device_type: "cuda" or "cpu" (where each rank's
    tensors lie).  The process group must be initialised with
    n_party * n_batch ranks."""
    if n_batch is None:
        return init_device_mesh(device_type, (n_party,), mesh_dim_names=("party",))
    return init_device_mesh(device_type, (n_party, n_batch), mesh_dim_names=("party", "batch"))


def axis(mesh: DeviceMesh, name: str) -> tuple[int, int]:
    """(this rank's coordinate, size) along a mesh axis; (0, 1) if the
    mesh has no such axis."""
    if name not in mesh.mesh_dim_names:
        return 0, 1
    return mesh.get_local_rank(name), mesh.size(mesh.mesh_dim_names.index(name))


def resident(x: torch.Tensor, k: int, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's parties of a per-party tensor: x[p*kp : (p+1)*kp] of the
    k parties, kp = k / n_party.  A tensor that already holds kp parties
    (as `shard_scheme` leaves it) is returned as it is."""
    pidx, n_party = axis(mesh, "party")
    kp = k // n_party
    if x.shape[0] == k:
        return x[pidx * kp : (pidx + 1) * kp]
    if x.shape[0] == kp:
        return x
    raise ValueError(f"a per-party tensor of {x.shape[0]} parties is neither all {k} nor this rank's {kp}")


def party_share(obj, pidx: int, n_party: int, shard_phase2: bool = False):
    """The share of a whole KmsScheme, MxKmsKeys or BmKmsPhase1 that rank
    `pidx` of a party axis of n_party ranks holds (`shard_scheme`), without
    a mesh: what a parent saves as one file a rank, so that a rank reads
    only its parties' keys from disk (`launch.Job`)."""
    if isinstance(obj, KmsScheme):
        k = obj.pub_b_hat.shape[0]
        names = PHASE1_FIELDS + (PHASE2_FIELDS if shard_phase2 else ())
    elif isinstance(obj, MxKmsKeys):
        k, names = obj.brk_mx.shape[0], ("brk_mx",)
    elif isinstance(obj, BmKmsPhase1):
        k, names = obj.brk_bm.shape[0], ("brk_bm",)
    else:
        raise TypeError(f"nothing to shard in a {type(obj).__name__}")
    if k % n_party:
        raise ValueError(f"{k} parties do not divide over {n_party} ranks of the party axis")
    kp = k // n_party
    return dataclasses.replace(obj, **{
        name: getattr(obj, name)[pidx * kp : (pidx + 1) * kp].clone()
        for name in names if getattr(obj, name).numel()  # an empty brk_hat (drop_brk) stays empty
    })


def shard_scheme(obj, mesh: DeviceMesh, shard_phase2: bool = False):
    """The rank's share of a whole KmsScheme, MxKmsKeys or BmKmsPhase1: the
    per-party phase-1 keys (`brk_hat`, `brk_mx`, `brk_bm`) cut to this
    rank's resident parties, and with shard_phase2 also the KmsScheme's
    phase-2 and key-switch keys (`PHASE2_FIELDS`); the rest replicated.  The
    cut parts are copies, so the whole tensors can be freed: a rank holds
    only its parties' keys (PARALLEL.md)."""
    pidx, n_party = axis(mesh, "party")
    return party_share(obj, pidx, n_party, shard_phase2)


def _issued(mesh: DeviceMesh, name: str) -> bool:
    """Whether a collective over mesh axis `name` is issued: not where the
    mesh has no such axis, nor over one rank of gloo (its collectives stage
    through the host: a one-rank one is a round trip for nothing); over one
    rank of NCCL it is, a copy on the card, so that a one-card run holds the
    collectives a run across cards makes, in its CUDA graph too."""
    if name not in mesh.mesh_dim_names:
        return False
    return axis(mesh, name)[1] > 1 or dist.get_backend(mesh.get_group(name)) == "nccl"


def gather(x: torch.Tensor, mesh: DeviceMesh, name: str, out: torch.Tensor | None = None) -> torch.Tensor:
    """x of every rank along mesh axis `name`, stacked in the axis' order:
    [size, *x.shape] (every rank's x has x's shape).  Written into `out` if
    given (what a CUDA graph's replay reads), else into a new tensor;
    NCCL: `all_gather_into_tensor`; gloo: the list form, which takes CUDA
    tensors itself, staging them through host memory (the compute stays on
    the card).  Where no collective is issued (`_issued`), a view of x."""
    if not _issued(mesh, name):
        return x.unsqueeze(0)
    x = x.contiguous()
    if out is None:
        out = x.new_empty((axis(mesh, name)[1], *x.shape))
    group = mesh.get_group(name)
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, name: str) -> torch.Tensor:
    """x summed over mesh axis `name`, in place; returns x."""
    if _issued(mesh, name):
        dist.all_reduce(x, group=mesh.get_group(name))
    return x


def kms_bootstrap_sharded(ct: Lwe, scheme: KmsScheme, params, mesh: DeviceMesh) -> Lwe:
    """Multi-key gate bootstrap over a (party, batch) mesh with the JAX
    partitioner path's semantics: phase 1 of each party on the party axis
    (the reference engine, on `scheme.brk_hat`), phase 2 and the key switch
    on the batch axis, replicated along the party axis.  PyTorch has no
    partitioner, so this is `kms_bootstrap_shardmap`'s program with the
    phase-2 gate split turned off (`shardmap.sharded_program`).  ct: the
    whole batch on every rank; every rank returns the whole Lwe."""
    from .shardmap import run_program, sharded_program  # shardmap imports this module

    return run_program(sharded_program(scheme, params, mesh), ct)
