"""Ring layer: exact torus/CRT arithmetic, negacyclic NTT, samplers.

Port of mktfhe_tpu/ring/.  Polynomials are plain tensors: [..., N] torus
coefficients (int32 / int64 carriers) or [..., nprimes, N] int32 CRT
residues in the evaluation domain.
"""
