"""phase1_ms: device ms of phase 1 (every party's sweep, `kernels/fused_mx3.py:phase1_sweep`
-> csrc/phase1_sweep.cu) in one eager bootstrap of a layer's inputs, from CUDA events at the
program's named ranges `mktfhe/phase1/party*` (less the lev-key lift inside them)."""


def read(r):
    ms = [v for name, v in r.phase_ms.items() if name.startswith("mktfhe/phase1/")]
    return sum(ms) if ms else None
