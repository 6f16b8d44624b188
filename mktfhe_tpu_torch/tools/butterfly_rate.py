"""What the card reaches on the sweep kernels' own butterflies in registers.

csrc/butterfly_rate.cu runs the lazy radix-8 butterflies of csrc/modarith.cuh
(`ct_lazy` forward, `gs_lazy` inverse) on 8 residues per thread with no
shared memory, no barriers and no loads inside the loop.  `measure` times it
with the sweeps' occupancy (one CTA of 512 threads per SM) and with as many
CTAs per SM as fit, and gives butterflies per second; chip_smoke.py prints,
beside each sweep's operation bound, the time its butterflies alone would
take at that rate.

Usage (one CUDA card):
  python -m mktfhe_tpu_torch.tools.butterfly_rate
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels.ntt import _kernel_tables
from ..ring.modring import PRIMES

SOURCE = _build.CSRC / "butterfly_rate.cu"
THREADS = 512  # csrc/butterfly_rate.cu:kRateThreads
ELEMS = 8
BUTTERFLIES_PER_ROUND = 12  # 3 stages on 8 residues
ONE_CTA_PER_SM = 120 * 1024  # dynamic shared memory that leaves no room for a second CTA


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.mktfhe_butterfly_rate.argtypes = [ptr, ptr, ptr, u32, u32, i32, i32, i32, i32, ptr]
    lib.mktfhe_butterfly_rate.restype = ctypes.c_int
    return lib


def run(device, forward: bool, rounds: int, ctas: int, shared_bytes: int, seed: int = 1) -> torch.Tensor:
    """One launch: [ctas * 512, 8] canonical residues mod the first prime
    (u32 bits in int32) after `rounds` rounds of three butterfly stages."""
    lib = load_library()
    tw, tw_sh, _ = _kernel_tables(64, 2, forward, device)
    out = torch.empty((ctas * THREADS, ELEMS), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mktfhe_butterfly_rate(
            out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), PRIMES[0], seed, rounds,
            int(forward), ctas, shared_bytes, stream,
        )
    _build.check_launch(lib, err, "butterfly rate kernel")
    return out


def measure(device, rounds: int = 4000, waves: int = 4) -> dict:
    """Butterflies per second, forward and inverse, at one CTA per SM
    (`*_one_cta`) and at full occupancy (`*_full`), by CUDA events around one
    launch each, after a warm-up launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"sms": sms, "rounds": rounds}
    for forward, name in ((True, "fwd"), (False, "inv")):
        for shared, tag, ctas in ((ONE_CTA_PER_SM, "one_cta", sms), (0, "full", sms * waves)):
            run(device, forward, 10, ctas, shared)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(device, forward, rounds, ctas, shared)
            end.record()
            torch.cuda.synchronize()
            butterflies = ctas * THREADS * rounds * BUTTERFLIES_PER_ROUND
            out[f"{name}_{tag}"] = butterflies / (start.elapsed_time(end) * 1e-3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("butterfly_rate: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, **measure(torch.device("cuda", 0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
