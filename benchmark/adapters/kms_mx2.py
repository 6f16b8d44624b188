"""The package under test for the binary-key KMS configurations on the mx
engine (`kernels/fused_mx2.py`): as `adapters/kms.py`, but the evaluator's
key set-up is the engine's own, `fused_mx2.setup`, which leaves out the
`brk_hat` images and holds the parties' keys in the mx domain instead.
The engine is then driven as every other: `bootstrap_mx2(ct, scheme,
params)`, captured and called through the gate entry.
"""

from __future__ import annotations

import torch

from mktfhe_tpu_torch.kernels.fused_mx2 import setup as _mx_setup  # an ImportError where the package lacks it

from .kms import (  # noqa: F401  (the family's entries, shared with the KMS configurations)
    PACKAGE,
    affine,
    build,
    capture,
    check_gates,
    engine,
    event_ranges,
    gate,
    lwe,
    params,
    party_key,
)


def setup(crs_polys: torch.Tensor, keys: list, port_params):
    """The evaluator's key set-up: `fused_mx2.setup`."""
    return _mx_setup(crs_polys, keys, port_params)
