"""hybrid_ms: device ms of phase 2's hybrid products (one a merge, `kms._phase2_party_mat` ->
`kernels/hybrid_product.py` -> csrc/hybrid_product.cu) in one eager bootstrap of a layer's inputs,
from CUDA events at the named ranges `mktfhe/phase2/hybrid` inside the merges; None where the
program opens no such range."""


def read(r):
    ms = [v for name, v in r.phase_ms.items() if name.startswith("mktfhe/phase2/hybrid")]
    return sum(ms) if ms else None
