"""phase2_ms: device ms of the lev-key lifts and phase 2's k merges (`kms.levkey_lift`,
`kms._phase2_party_mat`) in one eager bootstrap of a layer's inputs, from CUDA events at the
named ranges `mktfhe/levkey_lift` and `mktfhe/phase2/merge*`."""


def read(r):
    ms = [v for name, v in r.phase_ms.items()
          if name == "mktfhe/levkey_lift" or name.startswith("mktfhe/phase2/")]
    return sum(ms) if ms else None
