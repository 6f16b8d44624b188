"""Ciphertext algebra: keys, LWE/RLWE/RLEV/RGSW/UniEnc, gadget decomposition.

Port of mktfhe_tpu/ciphertext/: batched ciphertexts as stacked tensors;
evaluation-domain images are int32 CRT residue tensors from the exact NTT.
"""
