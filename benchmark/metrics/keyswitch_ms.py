"""keyswitch_ms: device ms of the modulus switch to 2^32 and the per-party key switch
(`kms._keyswitch` -> `common.limb_dot`) in one eager bootstrap of a layer's inputs, from CUDA
events at the named range `mktfhe/keyswitch`."""


def read(r):
    return r.phase_ms.get("mktfhe/keyswitch")
