"""sweep_roofline: the least time of the bootstrap's k phase-1 sweeps on the card (the
benchmark's frozen canonical radix-2 count: bytes over 3.35 TB/s against 32-bit integer
operations over an assumed 33.5 T/s, whichever is larger; party 1 sweeps one row, the
others l_lev) as a share of the measured phase 1: the sum of the exclusive times of every
range under `mktfhe/phase1/`, as `phase1_ms` reads it.  The count is the same whichever kernel
runs the sweeps: the ranges time B2 (csrc/phase1_sweep.cu) in the cells of `bootstrap_mx3` and
B5 (csrc/mx_sweep.cu) in `kms8-mx2-w128`."""

from benchmark import roofline


def read(r):
    phase1 = sum(v for name, v in r.phase_ms.items() if name.startswith("mktfhe/phase1/"))
    if not phase1 or r.tildea is None:
        return None
    p = r.params
    bound = 0.0
    for party in range(p.k):
        rows = 1 if party == 0 else p.l_lev
        distinct = int(r.tildea[:, party].unique().numel())
        bound += roofline.sweep_bound_ms(p, r.width, rows, distinct)
    return 100.0 * bound / phase1
