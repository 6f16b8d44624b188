"""phase1_ms: device ms of phase 1 (every party's sweep) in one eager bootstrap of a layer's
inputs, from CUDA events at the program's named ranges under `mktfhe/phase1/`.  The ranges
time the block-binary sweep B2 (`kernels/fused_mx3.py:phase1_sweep` -> csrc/phase1_sweep.cu)
in the cells of `bootstrap_mx3`, and the mx sweep B5 (`kernels/fused_mx2.py:mx_sweep` ->
csrc/mx_sweep.cu) in `kms8-mx2-w128`.  The metric is the sum of the exclusive times of every
range under `mktfhe/phase1/` (a nested range's time, such as the lev-key lift's, is its own and
left out of the range around it): a program that nests per-party ranges inside one enclosing
`mktfhe/phase1/...` range reports phase 1's wall time, each moment counted once."""


def read(r):
    ms = [v for name, v in r.phase_ms.items() if name.startswith("mktfhe/phase1/")]
    return sum(ms) if ms else None
