"""Command-line entry point: randomized gate-circuit trials per scheme preset.

Port of mktfhe_tpu/cli.py: keygen, the scheme's size, then trials of
random gate chains evaluated homomorphically and in the clear, a whole
batch of independent circuits per trial; a disagreement exits non-zero.
Every scheme runs its reference engine (`cggi.bootstrap`,
`lmss.bootstrap`, `ccs.bootstrap`, `kms.bootstrap`), each NTT through the
NTT kernel on the card.  On the card the trials go through the bootstrap
captured as one CUDA graph (graphs.py), as the JAX CLI's go through the
jitted one; `--device cpu` runs it eagerly.

    python -m mktfhe_tpu_torch.cli --preset KMS2party --trials 2 --batch 8
    python -m mktfhe_tpu_torch.cli --preset TinyCGGI --device cpu --seed 1
    python -m mktfhe_tpu_torch.cli --list

It runs on the card unless `--device cpu` is given, and refuses to start
when there is no card.  Keygen randomness comes from the ChaCha20 CSPRNG
(native/chacha.py), one freshly seeded generator per top-level stream of
each keygen; `--seed` makes a run deterministic.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import time

import numpy as np
import torch

# presets whose noise margin, measured on the reference's chip, sits below
# the 6-sigma bar (MARGINS.md): (measured sigma, the hardened variant)
_MARGINAL = {
    "CCS2party": ("2.5", "CCS2partyTight"),
    "CCS4party": ("1.8", "CCS4partyTight"),
}


def _sizeof(obj) -> str:
    """Bytes of every tensor field of a scheme (dataclass or NamedTuple)."""
    fields = obj._asdict().values() if hasattr(obj, "_asdict") else (
        getattr(obj, f.name) for f in dataclasses.fields(obj))
    total = float(sum(t.numel() * t.element_size() for t in fields))
    for unit in ("B", "KiB", "MiB", "GiB"):
        if total < 1024:
            return f"{total:.1f} {unit}"
        total /= 1024
    return f"{total:.1f} TiB"


def _keygen(params, device, keygen_gen, gen):
    """(LWE keys, scheme, the scheme's bootstrap, single_key) for `params`."""
    from .schemes import ccs, cggi, kms, lmss
    from .schemes.params import BlockParams, CcsParams, CggiParams

    if isinstance(params, CggiParams):
        lwe_key, _, scheme = cggi.setup(keygen_gen(cggi), params)
        return [lwe_key], scheme, cggi.bootstrap, True
    if isinstance(params, BlockParams):
        lwe_key, _, scheme = lmss.setup(keygen_gen(lmss), params)
        return [lwe_key], scheme, lmss.bootstrap, True
    mod = ccs if isinstance(params, CcsParams) else kms
    a = mod.crs(gen, params)
    parties = [mod.party_keygen(keygen_gen(mod), a, params) for _ in range(params.k)]
    scheme = mod.setup(a, [p[-1] for p in parties], params)
    return [p[0] for p in parties], scheme, mod.bootstrap, False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="CGGI", help="preset name (see --list)")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8, help="independent circuits per trial")
    ap.add_argument("--chain", type=int, default=None, help="gates per circuit (default: k, or 2)")
    ap.add_argument("--seed", type=int, default=None,
                    help="deterministic seed; by default every keygen stream is seeded from the "
                    "ChaCha20 CSPRNG (native/chacha.py)")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu runs the kernels' "
                    "plain versions)")
    args = ap.parse_args(argv)

    from .schemes.gates import (
        CLEAR_OPS,
        GATE_IDS,
        gate_affine,
        lwe_decrypt_bit,
        lwe_decrypt_bit_mk,
        lwe_encrypt_bit,
        lwe_ith_encrypt_bit,
    )
    from .schemes.presets import ALL_PRESETS

    if args.list:
        for name, p in ALL_PRESETS.items():
            print(f"{name:20s} {type(p).__name__}")
        return 0
    if args.preset not in ALL_PRESETS:
        print(f"unknown preset {args.preset!r}; see --list", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false; pass --device cpu to run the "
              "kernels' plain versions on the CPU", file=sys.stderr)
        return 2

    params = ALL_PRESETS[args.preset]
    if args.preset in _MARGINAL:
        sig, alt = _MARGINAL[args.preset]
        print(
            f"# WARNING: {args.preset}'s measured noise margin is {sig} sigma "
            f"(~per-gate error risk; the reference's own parameters measure "
            f"the same under its arithmetic, NOISE.md).  Prefer --preset {alt} "
            f"(same n/N/alpha/beta security surface, refined gadget)."
        )
    if args.seed is None:
        from .native.chacha import ChaCha20Stream, secure_generators

        stream = ChaCha20Stream()
        # messages, masks and trials: one generator, not secret material
        gen = torch.Generator(device=device).manual_seed(stream.secure_seed())
        nprng = np.random.default_rng(stream.secure_seed())

        def keygen_gen(mod):
            return secure_generators(mod.KEYGEN_STREAMS, device, stream)

        print("# seeds: ChaCha20 CSPRNG (pass --seed for determinism)")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        nprng = np.random.default_rng(args.seed)
        counter = itertools.count()

        def keygen_gen(mod):
            return torch.Generator(device=device).manual_seed(args.seed + 7000 + next(counter))

    print(f"KEY GENERATION ({args.preset}) on {device} ...")
    t0 = time.time()
    lwe_keys, scheme, bootstrap, single_key = _keygen(params, device, keygen_gen, gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"keygen {time.time() - t0:.1f}s; scheme size {_sizeof(scheme)}")

    k = 1 if single_key else params.k
    chain = args.chain or max(k, 2)
    g = args.batch
    op_names = list(GATE_IDS)

    from .ciphertext.lwe import Lwe
    from .graphs import capture_bootstrap

    # one batch of the trials' shape, the graph's example (on the CPU: the eager function)
    width, dtype = lwe_keys[0].n * (1 if single_key else params.k), lwe_keys[0].key.dtype
    example = Lwe(b=torch.zeros(g, dtype=dtype, device=device), a=torch.zeros((g, width), dtype=dtype, device=device))
    graphed = capture_bootstrap(bootstrap, scheme, params, example)
    if graphed.graph is not None:
        print(f"bootstrap captured as one CUDA graph: warm-up {graphed.warmup_s:.2f}s, capture "
              f"{graphed.capture_s:.2f}s, instantiate {graphed.instantiate_s:.2f}s, {graphed.nodes} nodes, "
              f"pool {graphed.pool_bytes / 2**20:.1f} MiB")

    def boot(ct):
        return graphed(ct, scheme, params)

    def encrypt(m, i):
        m = torch.from_numpy(m).to(device)
        if single_key:
            return lwe_encrypt_bit(gen, m, lwe_keys[0], params.alpha, (g,))
        return lwe_ith_encrypt_bit(gen, m, i, lwe_keys[i], params.alpha, k, (g,))

    failed = 0
    for trial in range(1, args.trials + 1):
        msgs = nprng.integers(0, 2, size=(chain, g)).astype(bool)
        ops = [op_names[j] for j in nprng.integers(0, len(op_names), size=chain - 1)]
        cts = [encrypt(msgs[i], i % k) for i in range(chain)]
        res, mres = cts[0], msgs[0]
        t0 = time.time()
        for i, op in enumerate(ops, start=1):
            res = boot(gate_affine(GATE_IDS[op], res, cts[i]))
            mres = np.array([CLEAR_OPS[op](bool(x), bool(y)) for x, y in zip(mres, msgs[i])])
        res.b.cpu()  # a device -> host read ends the timed chain
        dt = time.time() - t0
        got = (lwe_decrypt_bit(res, lwe_keys[0]) if single_key else lwe_decrypt_bit_mk(res, lwe_keys)).cpu().numpy()
        ok = bool(np.array_equal(got, mres))
        failed += not ok
        per_gate = dt / (len(ops) * g) * 1e3
        print(
            f"Trial {trial}: {' -> '.join(ops)} x{g} circuits: "
            f"{dt:.3f}s ({per_gate:.3f} ms/gate)  {'OK' if ok else 'MISMATCH'}"
        )
    if failed:
        print(f"{failed} of {args.trials} trials disagree with the clear circuit", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
