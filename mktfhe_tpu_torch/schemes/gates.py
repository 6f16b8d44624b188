"""Boolean gate API and the binary message layer (port of schemes/gates.py).

Encoding: mu = (2m - 1) * 2^(T-3), i.e. +-1/8 on the torus.  Gates compute
an affine combination, branchless over a per-gate opcode, then bootstrap.
"""

from __future__ import annotations

import functools

import torch

from ..ciphertext.keys import LweKey
from ..ciphertext.lwe import Lwe, lwe_sample, wrap_dot
from ..ring.torus import bits_of, divbits, to_carrier
from ..utils.profiling import host_span

# opcode -> (constant in eighths of the torus, sign, scale)
GATE_TABLE = {
    "NAND": (1, -1, 1),
    "AND": (7, 1, 1),
    "OR": (1, 1, 1),
    "XOR": (2, 1, 2),
    "XNOR": (6, -1, 2),
    "NOR": (7, -1, 1),
}
GATE_IDS = {name: i for i, name in enumerate(GATE_TABLE)}
_CONSTS = [v[0] for v in GATE_TABLE.values()]
_SIGNS = [v[1] * v[2] for v in GATE_TABLE.values()]

CLEAR_OPS = {
    "NAND": lambda x, y: not (x and y),
    "AND": lambda x, y: x and y,
    "OR": lambda x, y: x or y,
    "XOR": lambda x, y: x != y,
    "XNOR": lambda x, y: x == y,
    "NOR": lambda x, y: not (x or y),
}


def encode(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """m in {0,1} -> mu = (2m-1) * 2^(T-3) in the carrier `dtype`."""
    mu = 2 * m.long() - 1
    return to_carrier(mu << (bits_of(dtype) - 3), dtype)


def lwe_encrypt_bit(gen: torch.Generator, m: torch.Tensor, key: LweKey, alpha: float, shape=()) -> Lwe:
    """Single-key encryption of message bits."""
    ct = lwe_sample(gen, key, alpha, shape)
    return Lwe(b=ct.b + encode(m, ct.b.dtype), a=ct.a)


def lwe_ith_encrypt_bit(gen: torch.Generator, m: torch.Tensor, i: int, key: LweKey, alpha: float, k: int, shape=()) -> Lwe:
    """Party i's encryption in a k-party system: its mask occupies segment i
    of the concatenated k*n mask."""
    ct = lwe_sample(gen, key, alpha, shape)
    n = key.n
    a = torch.zeros((*ct.a.shape[:-1], k * n), dtype=ct.a.dtype, device=ct.a.device)
    a[..., i * n : (i + 1) * n] = ct.a
    return Lwe(b=ct.b + encode(m, ct.b.dtype), a=a)


def lwe_decrypt_bit(ct: Lwe, key: LweKey) -> torch.Tensor:
    """Single-key decrypt: round(phase * 8) == 1."""
    ph = ct.b + wrap_dot(ct.a, key.key)
    return divbits(ph, bits_of(ph.dtype) - 3) == 1


def lwe_decrypt_bit_mk(ct: Lwe, keys: list[LweKey]) -> torch.Tensor:
    """Multi-key decrypt: sum of per-party phases < q/2, as an unsigned
    compare -- a signed carrier is >= 0 exactly when its unsigned value is."""
    n = keys[0].n
    ph = ct.b
    for i, key in enumerate(keys):
        ph = ph + wrap_dot(ct.a[..., i * n : (i + 1) * n], key.key)
    return ph >= 0


@functools.lru_cache(maxsize=None)
def _gate_table(device) -> torch.Tensor:
    """The constants and signs by opcode, int64 [2, gates], made once per
    device: a copy from the host is a sync, and a chain of gates through a
    CUDA graph of the bootstrap (graphs.py) makes none."""
    return torch.tensor([_CONSTS, _SIGNS], dtype=torch.int64, device=device)


def gate_affine(op_id, ct1: Lwe, ct2: Lwe) -> Lwe:
    """Affine pre-bootstrap combination, branchless over a per-gate opcode
    (op_id: int or [G] integer tensor indexing GATE_IDS)."""
    dtype = ct1.b.dtype
    dev = ct1.b.device
    op = op_id if isinstance(op_id, int) else torch.as_tensor(op_id, dtype=torch.int64, device=dev)
    c, s = _gate_table(dev)[:, op]
    c = c << (bits_of(dtype) - 3)
    b = c + s * (ct1.b.long() + ct2.b.long())
    a = s[..., None] * (ct1.a.long() + ct2.a.long())
    return Lwe(b=to_carrier(b, dtype), a=to_carrier(a, dtype))


def not_gate(ct: Lwe) -> Lwe:
    """NOT: negate, no bootstrap."""
    return Lwe(b=-ct.b, a=-ct.a)


def gate(op, ct1: Lwe, ct2: Lwe, bootstrap_fn) -> Lwe:
    """Evaluate a (batched) boolean gate: affine combine + bootstrap.

    op: gate name, opcode int, or per-gate [G] opcode tensor.
    bootstrap_fn: the scheme's bootstrap closure (e.g. cggi.bootstrap
    partially applied with scheme and params).  Opens the host spans
    `mktfhe/gate` around it all and `mktfhe/gate/affine` around the affine
    (utils/profiling.py).
    """
    if isinstance(op, str):
        op = GATE_IDS[op]
    with host_span("mktfhe/gate"):
        with host_span("mktfhe/gate/affine"):
            ct = gate_affine(op, ct1, ct2)
        return bootstrap_fn(ct)
