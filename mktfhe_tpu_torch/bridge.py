"""Hand state between the JAX package and the port, as numpy arrays.

The reference's keys and ciphertexts come from jax.random streams that the
port cannot reproduce, so bit-level comparisons feed the reference's own
keygen output to the port: np.asarray of its arrays, turned here into the
port's tensors (u64 -> int64 view, u32 -> int32 view, int8 as is), and the
port's results turned back into unsigned numpy arrays.  The port's `setup`
then builds its own NTT-domain keys from the bridged party keys.  Nothing
here imports jax: any array np.asarray accepts will do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ciphertext.keys import LweKey
from .ciphertext.lwe import Lwe
from .kernels.batchminor import BmKmsPhase1
from .kernels.fused_mx2 import MxKmsKeys
from .schemes import params as _params
from .schemes.ccs import CcsPartyKey
from .schemes.cggi import CggiScheme
from .schemes.kms import KmsPartyKey, KmsScheme
from .schemes.lmss import LmssScheme

_VIEWS = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
_UNSIGNED = {torch.int64: np.uint64, torch.int32: np.uint32}


def from_numpy(x, device) -> torch.Tensor:
    """A reference array as the port's tensor, unsigned types viewed as the
    signed carriers of the same bits."""
    x = np.array(x, order="C")  # a writable copy
    if x.dtype in _VIEWS:
        x = x.view(_VIEWS[x.dtype])
    return torch.from_numpy(x).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port tensor back as numpy, int32/int64 carriers as uint32/uint64."""
    x = t.detach().cpu().contiguous().numpy()
    return x.view(_UNSIGNED[t.dtype]) if t.dtype in _UNSIGNED else x


def lwe_key(key, device) -> LweKey:
    """A reference LweKey (its `.key` array) on `device`."""
    return LweKey(key=from_numpy(key.key, device))


def lwe(ct, device) -> Lwe:
    """A reference Lwe ciphertext (`.b`, `.a`) on `device`."""
    return Lwe(b=from_numpy(ct.b, device), a=from_numpy(ct.a, device))


def party_key(pk, device) -> KmsPartyKey:
    """A reference KmsPartyKey (same field names) on `device`."""
    return KmsPartyKey(*(from_numpy(getattr(pk, f), device) for f in KmsPartyKey._fields))


def kms_scheme(scheme, device) -> KmsScheme:
    """A reference KmsScheme on `device`: residues u32 as int32, the int8
    key-switch tables as they are.  The reference's Shoup companions
    (`*_shoup`) have no counterpart in the port and are dropped."""
    return KmsScheme(**{f.name: from_numpy(getattr(scheme, f.name), device)
                        for f in dataclasses.fields(KmsScheme)})


def cggi_scheme(scheme, device) -> CggiScheme:
    """A reference CggiScheme on `device`: `brk_hat` u32 as int32 residues,
    the int8 key-switch tables as they are.  The reference's Shoup companion
    `brk_shoup` has no counterpart in the port and is dropped."""
    return CggiScheme(
        brk_hat=from_numpy(scheme.brk_hat, device),
        ksk_b=from_numpy(scheme.ksk_b, device),
        ksk_a=from_numpy(scheme.ksk_a, device),
    )


def lmss_scheme(scheme, device) -> LmssScheme:
    """A reference LmssScheme on `device`: `brk_hat` and `mono_hat` u32 as
    int32 residues, the int8 key-switch tables as they are.  The reference's
    Shoup companions `brk_shoup` and `mono_shoup` are dropped."""
    return LmssScheme(**{f.name: from_numpy(getattr(scheme, f.name), device)
                         for f in dataclasses.fields(LmssScheme)})


def ccs_party_key(pk, device) -> CcsPartyKey:
    """A reference CcsPartyKey (same field names) on `device`; the port's
    `ccs.setup` builds the NTT-domain scheme from it."""
    return CcsPartyKey(*(from_numpy(getattr(pk, f), device) for f in CcsPartyKey._fields))


def mx_kms_keys(keys, device) -> MxKmsKeys:
    """A reference MxKmsKeys on `device`: `brk_mx` u32 as int32 residues.  The
    reference's Shoup companion `brk_mx_shoup` has no counterpart in the port
    and is dropped."""
    return MxKmsKeys(brk_mx=from_numpy(keys.brk_mx, device))


def bm_kms_phase1(keys, device) -> BmKmsPhase1:
    """A reference BmKmsPhase1 on `device`, without its Shoup companions."""
    return BmKmsPhase1(
        brk_bm=from_numpy(keys.brk_bm, device), mono_hat=from_numpy(keys.mono_hat, device)
    )


def params(p):
    """A reference parameter dataclass as the port's class of the same name
    (the port dispatches on its own classes)."""
    return getattr(_params, type(p).__name__)(**dataclasses.asdict(p))
