"""mktfhe_tpu_torch: the PyTorch / CUDA port of mktfhe_tpu.

Multi-key TFHE over the torus (eprint 2022/1460) with exact CRT-NTT
arithmetic, written for PyTorch on an NVIDIA H100.  The JAX package
`mktfhe_tpu` is the reference: given the same keys and ciphertexts (passed
across as numpy arrays, see `bridge.py`), every function here returns the
same bits as its counterpart there.

Layout mirrors the JAX package (`ring/`, `ciphertext/`, `schemes/`,
`kernels/`).  Torus values on the 2^32 / 2^64 torus are carried in int32 /
int64 tensors (same bits; add and multiply wrap the same way); CRT residues
are non-negative int32 (< p < 2^30).  The hand-written CUDA kernels live in
`csrc/` and are built on first use; on CPU tensors every kernel wrapper
runs its plain PyTorch twin.

Importing this package never imports jax.
"""

__version__ = "0.1.0"
