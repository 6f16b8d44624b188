"""The CGGI gate bootstrap over the natural-layout NTT kernel.

Port of mktfhe_tpu/kernels/natural.py: `bootstrap_nat` there is the
reference engine with every NTT on the Pallas kernel in the natural layout
(`fwd_ntt_nat` / `inv_ntt_nat`), on the reference's CggiScheme.  The port's
`schemes/cggi.bootstrap` already is that engine (each of its NTTs goes
through kernels/ntt.py's wrappers of csrc/ntt.cu's natural kernel), so this
module names it; there is no second copy.
"""

from ..schemes.cggi import bootstrap as bootstrap_nat

__all__ = ["bootstrap_nat"]
