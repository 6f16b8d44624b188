"""Scheme layer: parameters, presets, the KMS multi-key scheme, gates.

Port of mktfhe_tpu/schemes/ (so far: KMS and its block variant).
"""
