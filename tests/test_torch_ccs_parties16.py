"""Port parity of the CCS gate bootstrap at the party count and gadget of
CCS16party (k = 16, l_uni 12, log_b_uni 2), at tests/test_ccs.py's TINY
width (n = 8, N = 64): the tests of test_torch_ccs_parties.py on this case.

Party 16's relinearisation contracts (k+1) * l_uni = 17 * 12 = 204 digit
products, the most of any preset.  A file of its own: the JAX compile of
sixteen parties' rotations takes most of its time, and `--dist loadfile`
gives each file a worker.
"""

import dataclasses

import pytest

from test_ccs import TINY
from test_torch_ccs_parties import (  # noqa: F401  (collected here on this file's case)
    reference_case,
    test_bootstrap_matches_reference,
    test_setup_matches_reference_images,
)

CCS16_TINY = dataclasses.replace(TINY, k=16, l_uni=12, log_b_uni=2)


@pytest.fixture(scope="module")
def case():
    return reference_case(CCS16_TINY)
