"""The plain reference of the binary-key KMS configurations that run on the
mx engine: the same scheme as `reference/kms.py`, whose binary-key path
(n key bits, one bit a phase-1 step, the key switch over all N ring
coefficients) serves them unchanged.  Only the program's engine and key
set-up differ (`adapters/kms_mx2.py`), so the reference is the KMS family's
own, by import.
"""

from .kms import *  # noqa: F401,F403
