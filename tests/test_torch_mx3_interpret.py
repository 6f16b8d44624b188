"""Port parity of the phase-1 sweep against the JAX package's own sweep.

The port's phase 1 (`kms_phase1_sweeps`, then `kms.levkey_lift`; on CPU:
the kernel's plain version party by party) against
the JAX package's `kms_phase1_mx3` with its Pallas kernel in interpret mode
(`interpret=True, g_tile=4`, as tests/test_fused_mx3.py runs it), at the
cases and on the keys of tests/test_torch_mx3.py; tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mktfhe_tpu.kernels.fused_mx3 import kms_phase1_mx3 as j_phase1_mx3
from mktfhe_tpu.ring.context import make_ring_ctx as j_ring_ctx

from test_torch_mx3 import _port_levkey, case  # noqa: F401  (`case` is a fixture)


@pytest.mark.parametrize("party", [0, 1], ids=["party0_row1", "party1_rows_l_lev"])
def test_phase1_matches_reference_mx3(case, party):  # noqa: F811
    params, keys3 = case["params"], case["jkeys3"]
    ctx = j_ring_ctx(params.big_n, params.ring_torus_bits, params.ring_nprimes)
    rows = 1 if party == 0 else params.l_lev
    ref = jax.jit(lambda ta: j_phase1_mx3(
        ta, keys3.brk_mx[party], keys3.brk_mx_shoup[party], rows, params, ctx,
        g_tile=4, interpret=True))
    want = np.asarray(ref(jnp.asarray(case["tildea"])))
    np.testing.assert_array_equal(_port_levkey(case, party), want)
