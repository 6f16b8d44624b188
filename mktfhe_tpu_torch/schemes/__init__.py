"""Scheme layer: parameters, presets, the CGGI single-key and KMS multi-key
schemes, gates.

Port of mktfhe_tpu/schemes/ (so far: CGGI, KMS and its block variant).
"""
