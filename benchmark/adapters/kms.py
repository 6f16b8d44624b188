"""The package under test for the KMS configurations: its parameter class,
its key set-up from the parties' keys, its gate entry and its engine.

The benchmark gives it what a deployment's evaluator receives: the CRS and
each party's public keys (made by `benchmark.reference.kms`), and
ciphertexts.  Everything it derives (the transformed keys, the graphs) is
its own; the reference works it out again.
"""

from __future__ import annotations

import importlib

import torch

from mktfhe_tpu_torch import graphs
from mktfhe_tpu_torch.ciphertext.lwe import Lwe
from mktfhe_tpu_torch.kernels import _build
from mktfhe_tpu_torch.schemes import gates, kms
from mktfhe_tpu_torch.schemes.params import KmsBlockParams, KmsParams
from mktfhe_tpu_torch.schemes.presets import ALL_PRESETS
from mktfhe_tpu_torch.utils.profiling import event_ranges  # noqa: F401  (the named ranges' CUDA-event ms)

from ..reference import kms as ref

PACKAGE = "mktfhe_tpu_torch"


def params(config: dict):
    """The package's parameter object for the configuration's numbers,
    checked against the preset the configuration names."""
    p = dict(config["params"])
    cls = KmsBlockParams if "d" in p else KmsParams
    out = cls(**{k: v for k, v in p.items() if k in cls.__dataclass_fields__})
    preset = ALL_PRESETS.get(config.get("preset"))
    if preset is not None and preset != out:
        raise ValueError(f"configuration {config['name']} differs from preset {config['preset']}: {preset} != {out}")
    return out


def check_gates() -> None:
    """The package numbers the gates as the benchmark does."""
    want = {name: i for i, name in enumerate(ref.GATE_NAMES)}
    if dict(gates.GATE_IDS) != want:
        raise ValueError(f"the package's gate ids {gates.GATE_IDS} differ from {want}")


def build() -> None:
    """Build (or find built) every CUDA library of the package, at once."""
    _build.build_all(sorted(_build.CSRC.glob("*.cu")))


def engine(name: str):
    """The bootstrap function named "module:function" under the package."""
    module, func = name.split(":")
    return getattr(importlib.import_module(f"{PACKAGE}.{module}"), func)


def party_key(pk: ref.PartyKeys) -> kms.KmsPartyKey:
    """One party's keys in the evaluator's input format (the key-switch
    table as int8 limbs [4, R] and [4, R, n])."""
    limbs = ref.to_limbs(pk.ksk)  # [R, 1 + n, 4]
    return kms.KmsPartyKey(
        pub_b=pk.pub_b, brk=pk.brk, rlk_d=pk.rlk_d, rlk_f=pk.rlk_f,
        ksk_b=limbs[:, 0].movedim(-1, 0).contiguous(), ksk_a=limbs[:, 1:].movedim(-1, 0).contiguous(),
    )


def setup(crs_polys: torch.Tensor, keys: list, port_params):
    """The evaluator's key set-up: `kms.setup`."""
    return kms.setup(crs_polys, keys, port_params)


def lwe(b: torch.Tensor, a: torch.Tensor) -> Lwe:
    return Lwe(b=b, a=a)


def gate(op: torch.Tensor, ct1: Lwe, ct2: Lwe, bootstrap_fn) -> Lwe:
    """The user's entry: `schemes.gates.gate`."""
    return gates.gate(op, ct1, ct2, bootstrap_fn)


def affine(op: torch.Tensor, ct1: Lwe, ct2: Lwe) -> Lwe:
    return gates.gate_affine(op, ct1, ct2)


def capture(bootstrap, scheme, port_params, example: Lwe):
    return graphs.capture_bootstrap(bootstrap, scheme, port_params, example)
