"""ChaCha20 CSPRNG (RFC 7539) in numpy, and torch generators seeded from it.

Port of mktfhe_tpu/native/chacha.py without its C fast path: the block
function runs on numpy uint32 arrays, vectorised over the blocks of a
request, so no compiler is called.  A `torch.Generator` (Philox on the card,
Mersenne Twister on the host) is a statistical generator, not a CSPRNG, and
holds only 64 bits of seed; `secure_generators` gives a keygen one generator
per top-level sampling stream (ring/sampler.rng_streams), each seeded from
two fresh ChaCha words, so that a keygen draws at least 256 bits of
CSPRNG output.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32)
# the double round: four column quarter-rounds, then four diagonal ones
_QUARTER_ROUNDS = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def _rotl(v: np.ndarray, c: int) -> np.ndarray:
    return (v << np.uint32(c)) | (v >> np.uint32(32 - c))


def _blocks(key_words: np.ndarray, nonce_words: np.ndarray, counters: np.ndarray) -> np.ndarray:
    """ChaCha20 blocks for uint32 counters [B]: [B, 16] uint32 words."""
    init = np.empty((16, len(counters)), dtype=np.uint32)
    init[:4] = _SIGMA[:, None]
    init[4:12] = key_words[:, None]
    init[12] = counters
    init[13:] = nonce_words[:, None]
    s = init.copy()
    for _ in range(10):
        for a, b, c, d in _QUARTER_ROUNDS:
            s[a] += s[b]
            s[d] = _rotl(s[d] ^ s[a], 16)
            s[c] += s[d]
            s[b] = _rotl(s[b] ^ s[c], 12)
            s[a] += s[b]
            s[d] = _rotl(s[d] ^ s[a], 8)
            s[c] += s[d]
            s[b] = _rotl(s[b] ^ s[c], 7)
    return (s + init).T


def chacha20_words(key: bytes, nonce: bytes, counter: int, nwords: int) -> np.ndarray:
    """nwords uint32 keystream words from block `counter` (RFC 7539)."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError(f"ChaCha20 takes a 32-byte key and a 12-byte nonce, got {len(key)} and {len(nonce)}")
    nblocks = (nwords + 15) // 16
    counters = (counter + np.arange(nblocks, dtype=np.uint64)).astype(np.uint32)
    words = _blocks(np.frombuffer(key, dtype="<u4").astype(np.uint32),
                    np.frombuffer(nonce, dtype="<u4").astype(np.uint32), counters)
    return words.reshape(-1)[:nwords]


class ChaCha20Stream:
    """Stateful keystream: each request starts at a fresh block."""

    def __init__(self, key: bytes | None = None, nonce: bytes = b"\x00" * 12):
        self.key = key if key is not None else os.urandom(32)
        self.nonce = nonce
        self.counter = 0

    def words(self, nwords: int) -> np.ndarray:
        out = chacha20_words(self.key, self.nonce, self.counter, nwords)
        self.counter += (nwords + 15) // 16
        return out

    def secure_seed(self) -> int:
        """A 64-bit seed from two fresh words."""
        w = self.words(2).astype(np.uint64)
        return int(w[0] | (w[1] << np.uint64(32)))


def secure_generators(n: int, device, stream: ChaCha20Stream | None = None) -> list[torch.Generator]:
    """n torch.Generators on `device`, each seeded from 2 fresh ChaCha words:
    a keygen's `gen` (ring/sampler.rng_streams) with 64 * n bits of CSPRNG
    entropy."""
    s = stream if stream is not None else ChaCha20Stream()
    data = s.words(2 * n).reshape(n, 2).astype(np.uint64)
    return [torch.Generator(device=device).manual_seed(int(lo | (hi << np.uint64(32)))) for lo, hi in data]
