"""Randomness for keys, masks and noise, drawn from a `torch.Generator`.

Port of mktfhe_tpu/ring/sampler.py.  Every sampler takes an explicit
generator and draws on that generator's device, so a keygen is replayable
from its seed.  The streams differ from the reference's jax.random
(threefry) streams: tests compare keys made here by distribution and by
decryption, and compare bits only on keys bridged from the reference.
"""

from __future__ import annotations

import torch

from .torus import bits_of


def rng_streams(gen, n: int) -> list[torch.Generator]:
    """The n top-level sampling streams of a keygen.

    `gen` is one `torch.Generator`, returned n times (its stream consumed in
    the order the keygen draws, the deterministic path), or a sequence of n
    generators, each seeded on its own (native/chacha.py:secure_generators:
    64 fresh bits of CSPRNG output each, so a keygen draws >= 256 bits).
    """
    if isinstance(gen, torch.Generator):
        return [gen] * n
    gens = list(gen)
    if len(gens) != n:
        raise ValueError(f"expected {n} generators, got {len(gens)}")
    return gens


def uniform_torus(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """Uniform torus elements; a 64-bit value is composed of two 32-bit draws."""
    dev = gen.device
    if bits_of(dtype) == 32:
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=dtype, generator=gen, device=dev)
    lo = torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=gen, device=dev)
    hi = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int64, generator=gen, device=dev)
    return (hi << 32) | lo


def uniform_binary(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """{0, 1} secrets."""
    return torch.randint(0, 2, shape, dtype=dtype, generator=gen, device=gen.device)


def uniform_ternary(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """{-1, 0, 1} secrets, in the torus carrier."""
    return torch.randint(-1, 2, shape, dtype=dtype, generator=gen, device=gen.device)


def block_binary(gen: torch.Generator, d: int, ell: int, dtype: torch.dtype) -> torch.Tensor:
    """Block-binary secret: d blocks of length ell, at most one 1 per block
    (per block draw idx ~ Uniform{0..ell}; idx == 0 is an all-zero block)."""
    idx = torch.randint(0, ell + 1, (d,), generator=gen, device=gen.device)
    pos = torch.arange(1, ell + 1, device=gen.device)
    return (idx[:, None] == pos).to(dtype).reshape(d * ell)


def gaussian_torus(gen: torch.Generator, shape, sigma: float, dtype: torch.dtype) -> torch.Tensor:
    """Rounded gaussian noise in absolute torus units, wrapped into the torus
    (float32 sampling is exact after rounding at these widths)."""
    e = torch.randn(shape, dtype=torch.float32, generator=gen, device=gen.device)
    return torch.round(e * sigma).to(torch.int32).to(dtype)
