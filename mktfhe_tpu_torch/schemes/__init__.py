"""Scheme layer: parameters, presets, the single-key CGGI and LMSS and the
multi-key CCS and KMS (with its block variant) schemes, gates.

Port of mktfhe_tpu/schemes/.
"""
