"""The port's ChaCha20 CSPRNG (mktfhe_tpu_torch/native/chacha.py) and its CLI
(mktfhe_tpu_torch/cli.py).

ChaCha: the RFC 7539 block vector of tests/test_native.py, the JAX
package's keystream for fixed keys, nonces and counters, and generators
seeded from two words each.  CLI: trials at the tiny presets on the CPU
(`--device cpu --seed 1`), ChaCha seeding, `--list`, and its refusal to run
on a card that is not there.
"""

import numpy as np
import pytest
import torch

from mktfhe_tpu.native.chacha import chacha20_words as j_chacha20_words
from mktfhe_tpu_torch import cli
from mktfhe_tpu_torch.native.chacha import ChaCha20Stream, chacha20_words, secure_generators
from mktfhe_tpu_torch.ring.sampler import rng_streams
from mktfhe_tpu_torch.schemes import ccs, cggi, kms, lmss


def test_rfc7539_block_vector():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    want = np.array([
        0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3, 0xC7F4D1C7, 0x0368C033, 0x9AAA2204, 0x4E6CD4C3,
        0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9, 0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2,
    ], dtype=np.uint32)
    np.testing.assert_array_equal(chacha20_words(key, nonce, 1, 16), want)


@pytest.mark.parametrize("counter,nwords", [(0, 48), (7, 5), (123456, 100)])
def test_words_match_reference(counter, nwords):
    key = bytes((7 * i + 3) % 256 for i in range(32))
    nonce = bytes(range(40, 52))
    got = chacha20_words(key, nonce, counter, nwords)
    assert got.dtype == np.uint32 and got.shape == (nwords,)
    np.testing.assert_array_equal(got, j_chacha20_words(key, nonce, counter, nwords))


def test_stream_advances_by_whole_blocks():
    s = ChaCha20Stream(key=bytes(32))
    a, b = s.words(20), s.words(3)
    np.testing.assert_array_equal(a, chacha20_words(bytes(32), bytes(12), 0, 20))
    np.testing.assert_array_equal(b, chacha20_words(bytes(32), bytes(12), 2, 3))
    with pytest.raises(ValueError):
        chacha20_words(bytes(31), bytes(12), 0, 1)


def test_secure_generators_draw_two_words_each():
    """Each keygen stream's generator is seeded from two fresh words: a
    keygen fed by secure_generators draws 64 * KEYGEN_STREAMS >= 256 bits."""
    for mod, n in ((cggi, 4), (lmss, 4), (ccs, 5), (kms, 7)):
        assert mod.KEYGEN_STREAMS == n
        s = ChaCha20Stream(key=bytes(32))
        gens = secure_generators(n, torch.device("cpu"), s)
        assert s.counter == (2 * n + 15) // 16 and 64 * n >= 256
        words = chacha20_words(bytes(32), bytes(12), 0, 2 * n).astype(np.uint64)
        seeds = [int(lo | (hi << np.uint64(32))) for lo, hi in words.reshape(n, 2)]
        assert [g.initial_seed() for g in gens] == seeds and len(set(seeds)) == n
        assert rng_streams(gens, n) == gens


def test_one_generator_is_every_stream():
    g = torch.Generator()
    assert rng_streams(g, 7) == [g] * 7
    with pytest.raises(ValueError):
        rng_streams([g, g], 3)


@pytest.mark.parametrize("preset", ["TinyCGGI", "TinyKMS2party"])
def test_cli_trials_on_cpu(preset, capsys):
    assert cli.main(["--preset", preset, "--device", "cpu", "--seed", "1", "--trials", "2", "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert f"KEY GENERATION ({preset})" in out and "scheme size" in out
    assert out.count("  OK") == 2 and "MISMATCH" not in out


def test_cli_chacha_seeding_and_list(capsys):
    assert cli.main(["--preset", "TinyCGGI", "--device", "cpu", "--trials", "1", "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert "ChaCha20 CSPRNG" in out and "  OK" in out
    assert cli.main(["--list"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert {"CGGI", "Block", "CCS2partyTight", "KMS8partyblock", "TinyCGGI"} <= set(names)


def test_cli_refuses_a_missing_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--preset", "TinyCGGI", "--trials", "1"]) != 0
    assert "--device cpu" in capsys.readouterr().err
