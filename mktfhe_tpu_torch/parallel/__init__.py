"""Multi-device multi-key bootstrapping over torch.distributed (port of
mktfhe_tpu/parallel/)."""

from .launch import run_ranks
from .mesh import kms_bootstrap_sharded, make_mesh, party_share, shard_scheme
from .shardmap import kms_bootstrap_shardmap

__all__ = [
    "kms_bootstrap_sharded",
    "kms_bootstrap_shardmap",
    "make_mesh",
    "party_share",
    "run_ranks",
    "shard_scheme",
]
