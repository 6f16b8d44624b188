"""The frozen canonical radix-2 count reproduces the smoke script's canonical
sweep bounds (KMS8partyblock 22.46 ms a party at G = 128, rows 3;
KMS32partyblock 22.41)."""

import json

import pytest

from benchmark import roofline
from benchmark.reference.kms import KmsSet

from conftest import ROOT


def _params(name):
    return KmsSet.from_config(json.loads((ROOT / "benchmark/configs" / f"{name}.json").read_text())["params"])


@pytest.mark.parametrize("name, npr, ms", [("KMS8partyblock", 4, 22.46), ("KMS32partyblock", 3, 22.41)])
def test_canonical_sweep_bound(name, npr, ms):
    p = _params(name)
    assert roofline.ring_nprimes(p) == npr
    assert round(roofline.sweep_bound_ms(p, 128, 3, 2 * p.big_n), 2) == ms


def test_bound_scales_with_the_gates_at_small_widths():
    p = _params("KMS8partyblock")
    assert roofline.sweep_bound_ms(p, 8, 3, 2 * p.big_n) == pytest.approx(22.455 / 16, rel=1e-3)
