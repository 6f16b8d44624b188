"""Plain reference of the KMS multi-key gate bootstrap (eprint 2022/1460).

Plain PyTorch, written from the scheme's definition (the SNUCP/MKTFHE Julia
sources: gate.jl, bootstrapping.jl:369-594, gsw.jl) and independent of the
package under test: it imports nothing of it and uses its own primes and
transforms.  It holds everything the benchmark makes and judges:

- the parties' keys, made on the device from the seed, as the parties
  (clients) of a deployment make them and send them to the evaluator: the
  LWE, ring and GSW secrets, the CRS, each party's public key, relinearisation
  key (a uni-encryption of its GSW key), blind-rotation key (RGSW of its LWE
  key bits) and key-switching table (LWE encryptions of its ring key's
  coefficients times each gadget digit value);
- encryption of input bits, multi-key decryption, the clear gates;
- the gate bootstrap itself, computed exactly in Z_{2^64}[X]/(X^N+1): gate
  affine, modulus switch to 2N, phase 1 (each party's blind rotation over an
  RLEV accumulator, block-binary or binary keys), phase 2 (k sequential
  merges: the LEV contraction with the lev key, the hybrid product with the
  relinearisation key), modulus switch to 2^32 and the per-party key switch.

Every ring product here is a small-digit polynomial times a torus
polynomial.  `ExactRing` computes it by a negacyclic number-theoretic
transform over four primes below 2^30 (their product, about 2^119.6, covers
four times the largest integer any contraction reaches, which `check_range`
asserts), then a balanced CRT reconstruction mod 2^64: the exact result.
`MatrixRing` computes the same residues and words with fewer passes over
memory (each transform as two float64 products of exact integers below
2^53): the bootstraps of the benchmark's check.  `F64Ring` computes the
same products by a float64 complex FFT, the precision of the scheme's
original Julia implementation (a 53-bit mantissa for 64-bit torus values):
the benchmark's control, which must fail the exact comparison.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

MASK32 = 0xFFFFFFFF

# gate name -> (constant in eighths of the torus, multiplier of ct1 + ct2)
# (gate.jl: a gate is an affine combination of its inputs, then a bootstrap)
GATES = {
    "NAND": (1, -1),
    "AND": (7, 1),
    "OR": (1, 1),
    "XOR": (2, 2),
    "XNOR": (6, -2),
    "NOR": (7, -1),
}
GATE_NAMES = tuple(GATES)
CLEAR = {
    "NAND": lambda x, y: ~(x & y) & 1,
    "AND": lambda x, y: x & y,
    "OR": lambda x, y: x | y,
    "XOR": lambda x, y: x ^ y,
    "XNOR": lambda x, y: ~(x ^ y) & 1,
    "NOR": lambda x, y: ~(x | y) & 1,
}


@dataclasses.dataclass(frozen=True)
class KmsSet:
    """A KMS parameter set as the configuration states it.  Block-binary
    keys when `ell` > 0 (d blocks of ell bits), binary keys of n bits
    otherwise.  Torus widths: 2^32 for LWE, 2^64 for the ring."""

    alpha: float
    f: int
    log_d: int
    big_n: int
    beta: float
    l_gsw: int
    log_b_gsw: int
    l_lev: int
    log_b_lev: int
    l_uni: int
    log_b_uni: int
    k: int
    d: int = 0
    ell: int = 0
    n_bits: int = 0

    @property
    def block(self) -> bool:
        return self.ell > 0

    @property
    def n(self) -> int:
        return self.d * self.ell if self.block else self.n_bits

    @property
    def members(self) -> int:
        """Key bits a phase-1 step takes: ell for block keys, 1 for binary."""
        return self.ell if self.block else 1

    @property
    def ksk_coeffs(self) -> int:
        """Ring-key coefficients the key switch tables cover: the block
        variant's first n pass for free (the ring key holds the LWE key)."""
        return self.big_n - self.n if self.block else self.big_n

    @classmethod
    def from_config(cls, p: dict) -> "KmsSet":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in p.items() if k in names}
        if "n" in p and "d" not in p:
            kw["n_bits"] = p["n"]
        return cls(**kw)


# --- seeds and sampling ------------------------------------------------------


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for one stream, fixed by the run's seed and the names."""
    h = hashlib.sha256("/".join(str(x) for x in (seed, *names)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *names))
    return gen


def uniform64(gen, shape) -> torch.Tensor:
    lo = torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=gen, device=gen.device)
    hi = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int64, generator=gen, device=gen.device)
    return (hi << 32) | lo


def uniform32(gen, shape) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, generator=gen, device=gen.device)


def gaussian(gen, shape, sigma: float) -> torch.Tensor:
    """Rounded gaussian noise, int64, in absolute torus units."""
    e = torch.randn(shape, dtype=torch.float64, generator=gen, device=gen.device)
    return torch.round(e * sigma).to(torch.int64)


def binary(gen, shape) -> torch.Tensor:
    return torch.randint(0, 2, shape, dtype=torch.int64, generator=gen, device=gen.device)


def ternary(gen, shape) -> torch.Tensor:
    return torch.randint(-1, 2, shape, dtype=torch.int64, generator=gen, device=gen.device)


def block_binary(gen, d: int, ell: int) -> torch.Tensor:
    """d blocks of ell bits with at most one set bit each (a block draws its
    set position uniformly from 0..ell, 0 meaning none)."""
    idx = torch.randint(0, ell + 1, (d,), generator=gen, device=gen.device)
    pos = torch.arange(1, ell + 1, device=gen.device)
    return (idx[:, None] == pos).to(torch.int64).reshape(d * ell)


# --- torus arithmetic (int64 carriers) ---------------------------------------


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """x mod 2^32 as an int32 carrier."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def gadget(l: int, log_b: int, bits: int) -> list[int]:
    """g_j = 2^(bits - (j+1) log_b), j = 0..l-1, as signed bits-bit values."""
    out = []
    for j in range(l):
        v = 1 << (bits - (j + 1) * log_b)
        out.append(v - (1 << bits) if v >> (bits - 1) else v)
    return out


def _shr(a: torch.Tensor, s: int, bits: int) -> torch.Tensor:
    """Logical right shift of a bits-bit value held in an int64."""
    if bits == 32:
        return (a & MASK32) >> s
    return (a >> s) & ((1 << (64 - s)) - 1)


def round_shift(a: torch.Tensor, s: int, bits: int) -> torch.Tensor:
    """round(a / 2^s) of a bits-bit torus value (a half rounds up), int64."""
    if s == 0:
        return a & MASK32 if bits == 32 else a
    return _shr(a, s, bits) + (_shr(a, s - 1, bits) & 1)


def decomp(a: torch.Tensor, l: int, log_b: int, bits: int) -> torch.Tensor:
    """Balanced gadget digits of bits-bit torus values: int64 [..., l] in
    [-B/2, B/2), digit j weighing g_j (j = 0 the most significant), by the
    carry chain of gsw.jl's decompto!: round to the l log_b top bits, then
    from the least significant digit up, a digit >= B/2 becomes d - B and
    carries one into the next; the carry out of the top digit wraps away."""
    mask, half = (1 << log_b) - 1, 1 << (log_b - 1)
    ai = round_shift(a.long(), bits - l * log_b, bits)
    digits = [None] * l
    for j in range(l - 1, -1, -1):
        d = ai & mask
        carry = (d >= half).long()
        digits[j] = d - (carry << log_b)
        ai = _shr(ai, log_b, 64) + carry
    return torch.stack(digits, dim=-1)


def negacyclic_roll(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """v(X) * X^shift mod X^N + 1; v [..., N], shift integer broadcastable
    to v.shape[:-1]."""
    n = v.shape[-1]
    lead = torch.broadcast_shapes(v.shape[:-1], shift.shape)
    ext = torch.cat([v, -v], dim=-1).expand(*lead, 2 * n)
    idx = torch.remainder(torch.arange(n, device=v.device) - shift.long()[..., None], 2 * n).expand(*lead, n)
    return torch.gather(ext, -1, idx)


def monomial_minus_one(a: torch.Tensor, n: int) -> torch.Tensor:
    """Coefficients of X^a - 1 mod X^N + 1 for amounts a [...] in [0, 2N):
    int64 [..., N]."""
    one = torch.zeros((*a.shape, n), dtype=torch.int64, device=a.device)
    one[..., 0] = 1
    return negacyclic_roll(one, a) - one


# --- rings -------------------------------------------------------------------


def _is_prime(p: int) -> bool:
    if p < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13):
        if p % q == 0:
            return p == q
    d, s = p - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in (2, 3, 5, 7):  # deterministic below 3.2e9
        x = pow(a, d, p)
        if x in (1, p - 1):
            continue
        for _ in range(s - 1):
            x = x * x % p
            if x == p - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, count: int = 4, below: int = 1 << 30) -> list[int]:
    """The `count` largest primes below `below` that are 1 mod 2N."""
    out, p = [], (below - 1) // (2 * n) * (2 * n) + 1
    while len(out) < count:
        if p < below and _is_prime(p):
            out.append(p)
        p -= 2 * n
    return out


def _root_2n(p: int, n: int) -> int:
    """A primitive 2N-th root of unity mod p."""
    for g in range(2, p):
        psi = pow(g, (p - 1) // (2 * n), p)
        if pow(psi, n, p) == p - 1:
            return psi
    raise ValueError(f"no 2N-th root mod {p}")


class ExactRing:
    """Exact negacyclic products mod 2^64 through an NTT over four primes
    below 2^30.  A transformed polynomial ("hat") is int64 residues
    [..., P, N]; products of two residues stay below 2^60."""

    exact = True  # its words are the exact result (F64Ring's are not)

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        ps = ntt_primes(n)
        self.primes = ps
        self.product = math.prod(ps)
        self.p = torch.tensor(ps, dtype=torch.int64, device=device)[:, None]  # [P, 1]

        def table(rows):
            return torch.tensor(rows, dtype=torch.int64, device=device)

        psi = [_root_2n(p, n) for p in ps]
        self.twist = table([[pow(s, j, p) for j in range(n)] for s, p in zip(psi, ps)])
        self.untwist = table([[pow(s, -j, p) * pow(n, -1, p) % p for j in range(n)] for s, p in zip(psi, ps)])
        # stage twiddles of the cyclic transform with root w = psi^2, per block size m
        self.fwd_tw, self.inv_tw = {}, {}
        m = n
        while m > 1:
            step = n // m
            self.fwd_tw[m] = table([[pow(s * s, j * step, p) for j in range(m // 2)] for s, p in zip(psi, ps)])[:, None]
            self.inv_tw[m] = table([[pow(s * s, -j * step, p) for j in range(m // 2)] for s, p in zip(psi, ps)])[:, None]
            m //= 2
        self.garner = [[pow(ps[j], -1, ps[i]) for j in range(i)] for i in range(len(ps))]
        self.prod64 = self.product % (1 << 64)
        if self.prod64 >= 1 << 63:
            self.prod64 -= 1 << 64

    def check_range(self, bound: int) -> None:
        """Refuse a contraction whose integers could reach a quarter of the
        primes' product: its reconstruction would not be exact."""
        if 4 * bound >= self.product:
            raise ValueError(f"contraction bound 2^{math.log2(bound):.1f} exceeds the CRT range")

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Torus or digit polynomials int64 [..., N] (signed: the balanced
        representative) -> hat [..., P, N]: twist by psi^j, then a cyclic
        decimation-in-frequency transform (output in bit-reversed order)."""
        n, p = self.n, self.p
        lead = x.shape[:-1]
        a = torch.remainder(x.long()[..., None, :], p)
        a = a * self.twist % p
        pp = p[:, :, None]
        m = n
        while m > 1:
            h = m // 2
            a = a.reshape(*lead, len(self.primes), n // m, 2, h)
            u, v = a[..., 0, :], a[..., 1, :]
            s = u + v
            s = torch.where(s >= pp, s - pp, s)
            t = (u - v + pp) * self.fwd_tw[m] % pp
            a = torch.stack((s, t), dim=-2)
            m = h
        return a.reshape(*lead, len(self.primes), n)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """hat [..., P, N] (residues in [0, p)) -> torus int64 [..., N]:
        the decimation-in-time inverse, untwist and 1/N, then the balanced
        CRT reconstruction mod 2^64 (Garner, Horner in wrapping int64)."""
        n, p = self.n, self.p
        lead = a.shape[:-2]
        pp = p[:, :, None]
        m = 2
        while m <= n:
            h = m // 2
            a = a.reshape(*lead, len(self.primes), n // m, 2, h)
            u, v = a[..., 0, :], a[..., 1, :] * self.inv_tw[m] % pp
            s = u + v
            s = torch.where(s >= pp, s - pp, s)
            t = u - v
            t = torch.where(t < 0, t + pp, t)
            a = torch.stack((s, t), dim=-2)
            m *= 2
        r = a.reshape(*lead, len(self.primes), n) * self.untwist % p
        ps = self.primes
        t = [r[..., 0, :]]
        for i in range(1, len(ps)):
            u = r[..., i, :]
            for j in range(i):
                u = torch.remainder((u - t[j]) * self.garner[i][j], ps[i])
            t.append(u)
        x = t[-1]
        for i in range(len(ps) - 2, -1, -1):
            x = t[i] + ps[i] * x
        return torch.where(t[-1] >= ps[-1] // 2, x - self.prod64, x)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a * b % self.p

    def sum(self, a: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum of hats along a batch axis `dim` (counted from the left or,
        if negative, before the [P, N] axes)."""
        return a.sum(dim if dim >= 0 else dim - 2) % self.p

    def mulsum(self, a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over the batch axis `dim` (as `sum`) of the products of two
        broadcast hats."""
        return self.sum(self.mul(a, b), dim)


LIMB = 1 << 15  # the float64 products' operands are cut into limbs below 2^15


class MatrixRing(ExactRing):
    """ExactRing's ring (its primes, residues and results, word for word)
    with fewer passes over memory: each transform is two float64 matrix
    products, a contraction runs in place.

    N = N1 N2 (N1 <= N2 <= 64).  The forward transform evaluates at the odd
    powers of psi, hat[k] = sum_j x_j psi^(j (2k + 1)) mod p, k = k1 + N1 k2,
    stored as [k1][k2]: with j = j1 N2 + j2, psi^(j (2k + 1)) =
    psi^(j1 N2 (2 k1 + 1)) psi^(j2 (2k + 1)), so a product over j1 (the
    same N1 x N1 matrix for every j2 and every prime's columns side by side)
    and then, for each (prime, k1), one over j2.  The inverse is the same
    two products backwards, with psi^-1 and 1/N.  Every product is of
    integers: its operands below 2^16 and 2^30, at most 128 terms, so each
    partial sum stays below 2^53 and float64 holds it exactly; a residue
    (below 2^30) enters as two 15-bit limbs, the high one against the matrix
    times 2^15 mod p, side by side along the contracted axis.  Torus inputs
    enter as four balanced 16-bit limbs, transformed together and summed
    with weights 2^16i mod p.  The CRT reconstruction is Garner's with one
    remainder a prime.  Hats are in another order than ExactRing's: the two
    rings' hats do not mix."""

    def __init__(self, n: int, device):
        super().__init__(n, device)
        n1 = 1 << ((n.bit_length() - 1) // 2)
        n2 = n // n1
        if n2 > 64:
            raise ValueError(f"N = {n}: the matrix products' sums would pass 2^53")
        self.n1, self.n2 = n1, n2
        ps = self.primes
        f64 = dict(dtype=torch.float64, device=device)
        self.pf = torch.tensor(ps, **f64)
        roots = [_root_2n(q, n) for q in ps]
        psi = torch.tensor([[pow(r, e, q) for e in range(2 * n)] for r, q in zip(roots, ps)],
                           dtype=torch.int64, device=device)  # [P, 2N]: psi^e
        ninv = torch.tensor([pow(n, -1, q) for q in ps], dtype=torch.int64, device=device)
        i1 = torch.arange(n1, device=device)
        i2 = torch.arange(n2, device=device)

        def powers(e):  # psi^e of each prime for exponents e [...]: [P, ...]
            return psi[:, torch.remainder(e, 2 * n).reshape(-1)].reshape(len(ps), *e.shape)

        def limbed(m, axis):  # m and 2^15 m mod p side by side along `axis`, float64
            p = self.p.view(-1, *[1] * (m.dim() - 1))
            return torch.cat([m, m * LIMB % p], dim=axis).to(torch.float64)

        odd1 = 2 * i1 + 1
        odd = odd1[:, None] + 2 * n1 * i2  # [k1, k2]: 2k + 1
        # forward: [j1, (P, k1)]; [P, k1, (limb, j2), k2]
        self.f1 = powers(n2 * i1[:, None] * odd1).permute(1, 0, 2).reshape(n1, -1).to(torch.float64)
        self.f2 = limbed(powers(i2[None, :, None] * odd[:, None, :]), 2)
        # inverse: [P, k1, (limb, k2), j2], 1/N in it; [P, (limb, k1), j1]
        self.g2 = limbed(powers(-i2[None, None, :] * odd[:, :, None]) * ninv[:, None, None, None]
                         % self.p[:, :, None, None], 2)
        self.g1 = limbed(powers(-n2 * i1[None, :] * odd1[:, None]), 1)
        self.limb_w = torch.tensor([[pow(2, 16 * i, q) for q in ps] for i in range(4)], dtype=torch.int64,
                                   device=device)[:, :, None]  # [4, P, 1]: 2^16i mod p
        prefix = [math.prod(ps[:j]) for j in range(len(ps))]
        self.garner_c = []  # t_i = r_i c_ii + sum_j<i t_j c_ij mod p_i
        for i, q in enumerate(ps):
            c = pow(prefix[i], -1, q)
            self.garner_c.append([(-prefix[j] * c) % q for j in range(i)] + [c])

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Integer polynomials int64 [..., N] (signed) -> hat [..., P, N]."""
        x = x.long()
        lo, hi = x.aminmax() if x.numel() else (0, 0)
        if -(1 << 16) <= lo and hi <= 1 << 16:
            return self._fwd_small(x)
        limbs = []  # x = sum_i c_i 2^16i, c_i in [-2^15, 2^15] (the top one takes what is left)
        for _ in range(3):
            c = ((x + LIMB) & 0xFFFF) - LIMB
            limbs.append(c)
            x = (x >> 16) + (c < 0).long()
        limbs.append(x)
        h = self._fwd_small(torch.stack(limbs))  # [4, ..., P, N]
        w = self.limb_w.reshape(4, *[1] * (h.dim() - 3), len(self.primes), 1)
        out = h[0]
        for i in range(1, 4):
            out.addcmul_(h[i], w[i])
        return out.remainder_(self.p)

    def _fwd_small(self, x: torch.Tensor) -> torch.Tensor:
        """fwd of coefficients of magnitude at most 2^16."""
        n, n1, n2, npr = self.n, self.n1, self.n2, len(self.primes)
        lead = x.shape[:-1]
        m = math.prod(lead)
        xt = torch.empty((m, n2, n1), dtype=torch.float64, device=x.device)
        xt.copy_(x.reshape(m, n1, n2).transpose(1, 2))
        y = (xt.view(m * n2, n1) @ self.f1).view(m, n2, npr, n1)  # [m, j2, P, k1]
        del xt
        y = torch.remainder(y, self.pf[:, None])
        z = self._product(y.permute(2, 3, 0, 1), self.f2)  # [P, k1, m, k2]
        del y
        out = torch.empty((m, npr, n1, n2), dtype=torch.int64, device=x.device)
        out.copy_(z.permute(2, 0, 1, 3))
        return out.view(*lead, npr, n)

    def _product(self, r: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
        """Residues r [P, B, m, K] (float64 or int64, below 2^30) contracted
        with mat [P, B, 2K, C] (the matrix and its 2^15 multiple): the
        residues float64 [P, B, m, C]."""
        npr, b, m, k = r.shape
        limbs = torch.empty((npr, b, m, 2 * k), dtype=torch.float64, device=r.device)
        lo, hi = limbs[..., :k], limbs[..., k:]
        lo.copy_(r)
        torch.div(lo, float(LIMB), rounding_mode="floor", out=hi)
        lo.add_(hi, alpha=-float(LIMB))
        z = torch.bmm(limbs.view(npr * b, m, 2 * k), mat.reshape(npr * b, 2 * k, -1)).view(npr, b * m, -1)
        del limbs
        return torch.remainder(z, self.pf[:, None, None], out=z).view(npr, b, m, -1)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """hat [..., P, N] (residues in [0, p)) -> torus int64 [..., N]."""
        n, n1, n2, ps = self.n, self.n1, self.n2, self.primes
        npr = len(ps)
        lead = a.shape[:-2]
        m = math.prod(lead)
        z = self._product(a.reshape(m, npr, n1, n2).permute(1, 2, 0, 3), self.g2)  # [P, k1, m, j2]
        x = self._product(z.permute(0, 2, 3, 1).reshape(npr, 1, m * n2, n1), self.g1[:, None])  # [P, 1, m j2, j1]
        del z
        r = torch.empty((npr, m, n1, n2), dtype=torch.int64, device=a.device)
        r.copy_(x.view(npr, m, n2, n1).transpose(-1, -2))
        del x
        t = []
        for i, q in enumerate(ps):
            c = self.garner_c[i]
            u = r[i] * c[i]
            for j in range(i):
                u.add_(t[j], alpha=c[j])
            t.append(u.remainder_(q))
        x = t[-1]
        for i in range(npr - 2, -1, -1):
            x = torch.add(t[i], x, alpha=ps[i])
        x = torch.where(t[-1] >= ps[-1] // 2, x - self.prod64, x)
        return x.view(*lead, n)

    def mulsum(self, a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
        """As ExactRing.mulsum, accumulated in place term by term: residues
        below 2^30, so a remainder after every seven products keeps the sum
        below 2^63."""
        d = dim if dim >= 0 else dim - 2
        terms = max(a.shape[d], b.shape[d])
        out = None
        for i in range(terms):
            ai = a.select(d, i if a.shape[d] > 1 else 0)
            bi = b.select(d, i if b.shape[d] > 1 else 0)
            if out is None:
                out = ai * bi
            else:
                out.addcmul_(ai, bi)
            if i % 7 == 6:
                out.remainder_(self.p)
        return out.remainder_(self.p)


class F64Ring:
    """The same products by a float64 complex FFT of size N (the
    precision of the scheme's Julia implementation): the control.  A hat is
    complex128 [..., N]; torus operands lose their low bits to the 53-bit
    mantissa, and sums lose bits in rounding."""

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        j = torch.arange(n, dtype=torch.float64, device=device)
        self.zeta = torch.exp(1j * math.pi * j / n)
        self.zeta_inv = torch.exp(-1j * math.pi * j / n)

    def check_range(self, bound: int) -> None:
        pass

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        return torch.fft.fft(x.to(torch.float64) * self.zeta, dim=-1)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        z = torch.round((torch.fft.ifft(a, dim=-1) * self.zeta_inv).real)
        r = z - torch.floor(z / 2.0**64) * 2.0**64  # [0, 2^64)
        hi = torch.floor(r / 2.0**32)
        lo = r - hi * 2.0**32
        return (hi.to(torch.int64) << 32) + lo.to(torch.int64)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a * b

    def sum(self, a: torch.Tensor, dim: int) -> torch.Tensor:
        return a.sum(dim if dim >= 0 else dim - 1)

    exact = False
    mulsum = ExactRing.mulsum


# --- keys --------------------------------------------------------------------


@dataclasses.dataclass
class PartySecrets:
    lwe: torch.Tensor  # [n] int64 0/1
    uni: torch.Tensor  # [N] int64 0/1; block: its first n coefficients are `lwe`
    gsw: torch.Tensor  # [N] int64 0/1


@dataclasses.dataclass
class PartyKeys:
    """One party's public material, torus domain, as it is sent to the
    evaluator."""

    pub_b: torch.Tensor  # [l_uni, N] int64
    rlk_d: torch.Tensor  # [l_uni, N]
    rlk_f: torch.Tensor  # [l_uni, 2, N]
    brk: torch.Tensor | None  # [n, 2, l_gsw, 2, N] int64
    ksk: torch.Tensor | None  # [R, 1 + n] int32: (b, a) of each table row


def _ring_mul(ring: ExactRing, small: torch.Tensor, big: torch.Tensor) -> torch.Tensor:
    """small (a secret, coefficients of magnitude <= 1) times torus
    polynomials, exact."""
    return ring.inv(ring.mul(ring.fwd(small), ring.fwd(big)))


def crs(params: KmsSet, seed: int, device) -> torch.Tensor:
    """The common reference string [l_uni, N] int64."""
    return uniform64(generator(device, seed, "crs"), (params.l_uni, params.big_n))


def party_secrets(params: KmsSet, seed: int, party: int, device) -> PartySecrets:
    gen = generator(device, seed, "party", party, "secrets")
    if params.block:
        lwe = block_binary(gen, params.d, params.ell)
        uni = torch.cat([lwe, binary(gen, (params.big_n - params.n,))])
    else:
        lwe = binary(gen, (params.n,))
        uni = binary(gen, (params.big_n,))
    return PartySecrets(lwe=lwe, uni=uni, gsw=binary(gen, (params.big_n,)))


def rlwe_zero(ring: ExactRing, key: torch.Tensor, sigma: float, gen, shape) -> torch.Tensor:
    """RLWE encryptions of zero under a rank-1 ring key: [*shape, 2, N]
    with component 0 = e - key * a, component 1 = a."""
    a = uniform64(gen, (*shape, ring.n))
    b = gaussian(gen, (*shape, ring.n), sigma) - _ring_mul(ring, key, a)
    return torch.stack([b, a], dim=-2)


def party_keys(params: KmsSet, seed: int, party: int, crs_polys: torch.Tensor, ring: ExactRing,
               with_brk: bool = True, with_ksk: bool = True) -> PartyKeys:
    """One party's public keys, each drawn from its own stream (so any of
    them can be made again alone)."""
    dev = crs_polys.device
    sec = party_secrets(params, seed, party, dev)
    beta = params.beta
    g_uni = torch.tensor(gadget(params.l_uni, params.log_b_uni, 64), dtype=torch.int64, device=dev)

    gen = generator(dev, seed, "party", party, "pub")
    pub_b = gaussian(gen, crs_polys.shape, beta) - _ring_mul(ring, sec.uni, crs_polys)

    # the relinearisation key: a uni-encryption of the GSW key under the ring key
    gen = generator(dev, seed, "party", party, "rlk")
    r = ternary(gen, (params.big_n,))
    rlk_d = _ring_mul(ring, r, crs_polys) + g_uni[:, None] * sec.gsw + gaussian(gen, crs_polys.shape, beta)
    rlk_f = rlwe_zero(ring, sec.uni, beta, gen, (params.l_uni,))
    rlk_f[:, 0] += g_uni[:, None] * r

    brk = ksk = None
    if with_brk:
        gen = generator(dev, seed, "party", party, "brk")
        g = torch.tensor(gadget(params.l_gsw, params.log_b_gsw, 64), dtype=torch.int64, device=dev)
        brk = rlwe_zero(ring, sec.gsw, beta, gen, (params.n, 2, params.l_gsw))  # [n, cin, l, cout, N]
        for c in range(2):  # row (cin, j) carries bit * g_j on component cin, coefficient 0
            brk[:, c, :, c, 0] += sec.lwe[:, None] * g
    if with_ksk:
        ksk = ksk_table(params, sec, generator(dev, seed, "party", party, "ksk"))
    return PartyKeys(pub_b=pub_b, rlk_d=rlk_d, rlk_f=rlk_f, brk=brk, ksk=ksk)


def ksk_table(params: KmsSet, sec: PartySecrets, gen) -> torch.Tensor:
    """LWE encryptions (2^32 torus, under the party's LWE key) of
    coeff_i * g_j * v for each covered ring-key coefficient i, level j < f
    and digit value v = 1..D/2, rows in that order: [R, 1 + n] int32."""
    coeffs = sec.uni[params.big_n - params.ksk_coeffs:]
    g = torch.tensor(gadget(params.f, params.log_d, 32), dtype=torch.int64, device=coeffs.device)
    vals = torch.arange(1, (1 << (params.log_d - 1)) + 1, device=coeffs.device)
    msgs = (coeffs[:, None, None] * g[None, :, None] * vals).reshape(-1)
    b, a = lwe_encrypt(gen, msgs, sec.lwe, params.alpha)
    return torch.cat([b[:, None], a], dim=1)


def to_limbs(v: torch.Tensor) -> torch.Tensor:
    """u32 values (any int carrier) -> int8 [..., 4] balanced limbs, v =
    sum l_j 2^(8j) mod 2^32: the evaluator's key-switch table format."""
    v = v.long() & MASK32
    limbs = []
    for _ in range(4):
        d = v & 0xFF
        carry = d >> 7
        v = (v >> 8) + carry
        limbs.append((d - (carry << 8)).to(torch.int8))
    return torch.stack(limbs, dim=-1)


# --- LWE layer ---------------------------------------------------------------


def lwe_encrypt(gen, msgs: torch.Tensor, key: torch.Tensor, sigma: float):
    """b = m + e - <a, s> on the 2^32 torus: (b [M] int32, a [M, n] int32)."""
    a = uniform32(gen, (*msgs.shape, key.shape[0]))
    b = msgs + gaussian(gen, msgs.shape, sigma) - (a.long() * key).sum(-1)
    return wrap32(b), a


def encode(bits: torch.Tensor) -> torch.Tensor:
    """m in {0, 1} -> (2m - 1) / 8 of the 2^32 torus, int64."""
    return (2 * bits.long() - 1) << 29


def encrypt_bits(gen, bits: torch.Tensor, party: torch.Tensor, secrets: list[PartySecrets], sigma: float):
    """Each bit encrypted by its party, its mask in that party's segment of
    the k*n mask: (b [M] int32, a [M, k*n] int32)."""
    k, n = len(secrets), secrets[0].lwe.shape[0]
    keys = torch.stack([s.lwe for s in secrets])  # [k, n]
    a_own = uniform32(gen, (*bits.shape, n))
    e = gaussian(gen, bits.shape, sigma)
    b = encode(bits) + e - (a_own.long() * keys[party]).sum(-1)
    a = torch.zeros((*bits.shape, k, n), dtype=torch.int32, device=bits.device)
    a.scatter_(-2, party[..., None, None].expand(*bits.shape, 1, n), a_own[..., None, :])
    return wrap32(b), a.reshape(*bits.shape, k * n)


def phase32(b: torch.Tensor, a: torch.Tensor, secrets: list[PartySecrets]) -> torch.Tensor:
    """b + sum_i <a_i, s_i> mod 2^32, as int32."""
    keys = torch.cat([s.lwe for s in secrets])
    return wrap32(b.long() + (a.long() * keys).sum(-1))


def decrypt(b: torch.Tensor, a: torch.Tensor, secrets: list[PartySecrets]) -> torch.Tensor:
    """Multi-key decryption: the phase lies in [0, 1/2) of the torus for a 1."""
    return (phase32(b, a, secrets) >= 0).long()


def gate_affine(op: torch.Tensor, b1, a1, b2, a2):
    """The gates' affine combination (gate.jl), op an index into GATE_NAMES."""
    table = torch.tensor([GATES[g] for g in GATE_NAMES], dtype=torch.int64, device=op.device)
    c, s = table[op, 0] << 29, table[op, 1]
    b = c + s * (b1.long() + b2.long())
    a = s[:, None] * (a1.long() + a2.long())
    return wrap32(b), wrap32(a)


def clear_gate(op, x, y):
    """The gates on clear bits (numpy or torch integer arrays)."""
    out = x * 0
    for i, name in enumerate(GATE_NAMES):
        out = out + (op == i) * CLEAR[name](x, y)
    return out


# --- the bootstrap -----------------------------------------------------------


def mod_switch(x: torch.Tensor, n: int) -> torch.Tensor:
    """2^32 torus -> Z_2N: round(x * 2N / 2^32) mod 2N."""
    return round_shift(x.long(), 32 - (n.bit_length() - 1) - 1, 32) & (2 * n - 1)


def check_ranges(ring, params: KmsSet) -> None:
    """Every contraction's integers within the exact ring's range: phase 1's
    monomial-weighted external products, phase 2's LEV contraction, hybrid
    product (summed over up to k components) and uni-digit products."""
    n, top = params.big_n, 1 << 63
    ring.check_range(params.members * 2 * 2 * params.l_gsw * (1 << (params.log_b_gsw - 1)) * top * n)
    ring.check_range(params.l_lev * (1 << (params.log_b_lev - 1)) * top * n)
    ring.check_range(params.k * params.l_uni * (1 << (params.log_b_uni - 1)) * top * n)


def phase1(ring, params: KmsSet, tildea: torch.Tensor, brk_hat: torch.Tensor) -> torch.Tensor:
    """The blind rotations of several parties at once.  tildea [q, S, n]
    (each party's rotation amounts), brk_hat [q, n, 2l, 2, *hat] (their
    blind-rotation keys transformed).  Returns each party's lev key, torus
    [q, S, l_lev, 2, N]: from RLEV rows carrying the LEV gadget, per step
    acc += sum over the step's key bits m of (X^{a_m} - 1) * (G^-1(acc) x
    brk_m), the digits balanced (l_gsw, log_b_gsw)."""
    q, s = tildea.shape[:2]
    n, rows, l = params.big_n, params.l_lev, params.l_gsw
    mem = params.members
    dev = tildea.device
    acc = torch.zeros((q, s, rows, 2, n), dtype=torch.int64, device=dev)
    acc[:, :, :, 0, 0] = torch.tensor(gadget(rows, params.log_b_lev, 64), dtype=torch.int64, device=dev)
    amounts = tildea.reshape(q, s, params.n // mem, mem)
    for step in range(params.n // mem):
        dig = decomp(acc, l, params.log_b_gsw, 64)  # [q, S, rows, 2, N, l]
        dhat = ring.fwd(dig.movedim(-1, -2).reshape(q, s, rows, 2 * l, n))  # [q, S, rows, 2l, *hat]
        mono = ring.fwd(monomial_minus_one(amounts[:, :, step], n))  # [q, S, mem, *hat]
        # the step's key rows, each weighted by its monomial: sum_m (X^{a_m} - 1) brk_m
        key = ring.mulsum(mono[:, :, :, None, None], brk_hat[:, None, step * mem:(step + 1) * mem], -3)
        acc = acc + ring.inv(ring.mulsum(dhat[:, :, :, :, None], key[:, :, None], -2))  # key [q, S, 2l, 2, *hat]
    return acc


def brk_hats(ring, keys: list[PartyKeys]) -> torch.Tensor:
    """Parties' blind-rotation keys [n, 2, l, 2, N] -> [q, n, 2l, 2, *hat]."""
    out = []
    for pk in keys:
        nb, cin, l, cout, n = pk.brk.shape
        out.append(ring.fwd(pk.brk.reshape(nb, cin * l, cout, n)))
    return torch.stack(out)


def phase2(ring, params: KmsSet, tildeb: torch.Tensor, levkeys: torch.Tensor, keys: list[PartyKeys],
           crs_polys: torch.Tensor) -> torch.Tensor:
    """The k sequential merges from the test vector X^tildeb * (-1/8) *
    sum_i X^i.  levkeys [k, S, l_lev, 2, N] torus (party 1 reads row 0
    only).  Returns the accumulator [S, k+1, N] int64."""
    s, n, k = tildeb.shape[0], params.big_n, params.k
    dev = tildeb.device
    acc = torch.zeros((s, k + 1, n), dtype=torch.int64, device=dev)
    acc[:, 0] = negacyclic_roll(torch.full((n,), -(1 << 61), dtype=torch.int64, device=dev), tildeb)
    crs_hat = ring.fwd(crs_polys)  # [l_uni, *hat]
    pub_hat = ring.fwd(torch.stack([pk.pub_b for pk in keys]))  # [k, l_uni, *hat]
    for p1 in range(1, k + 1):
        pk = keys[p1 - 1]
        rows = 1 if p1 == 1 else params.l_lev
        lev_hat = ring.fwd(levkeys[p1 - 1][:, :rows])  # [S, rows, 2, *hat]
        dig = decomp(acc[:, :p1], params.l_lev, params.log_b_lev, 64)[..., :rows]  # [S, p1, N, rows]
        dhat = ring.fwd(dig.movedim(-1, -2))  # [S, p1, rows, *hat]
        x = ring.inv(ring.mulsum(dhat, lev_hat[:, None, :, 0], -1))  # [S, p1, N]
        y = ring.inv(ring.mulsum(dhat, lev_hat[:, None, :, 1], -1))
        # hybrid product of y with party p1's relinearisation key
        yhat = ring.fwd(decomp(y, params.l_uni, params.log_b_uni, 64).movedim(-1, -2))  # [S, p1, l_uni, *hat]
        u = ring.inv(ring.mulsum(yhat, ring.fwd(pk.rlk_d), -1))  # [S, p1, N]
        v = ring.mulsum(yhat[:, 0], crs_hat, -1)  # component 0 against the CRS, negated
        v = ring.inv(v)
        v = -v
        if p1 > 1:  # component c against party c's public key
            v = v + ring.inv(ring.sum(ring.mulsum(yhat[:, 1:], pub_hat[: p1 - 1], -1), -1))
        vhat = ring.fwd(decomp(v, params.l_uni, params.log_b_uni, 64).movedim(-1, -2))  # [S, l_uni, *hat]
        f_hat = ring.fwd(pk.rlk_f)  # [l_uni, 2, *hat]
        w_b = ring.inv(ring.mulsum(vhat, f_hat[:, 0], -1))
        w_a = ring.inv(ring.mulsum(vhat, f_hat[:, 1], -1))
        new = x + u
        new[:, 0] += w_b
        acc = torch.zeros_like(acc)
        acc[:, :p1] = new
        acc[:, p1] = w_a
    return acc


def keyswitch(params: KmsSet, acc: torch.Tensor, keys: list[PartyKeys], chunk: int = 4):
    """Modulus switch 2^64 -> 2^32 (the high word), sample extraction, then
    per party the key switch: each covered coefficient's balanced digits
    (f, log_d) select signed rows of the party's table.  Returns (b [S]
    int32, a [S, k*n] int32)."""
    hi = acc >> 32  # [S, k+1, N]: the high words
    b = hi[:, 0, 0].clone()
    masks = hi[:, 1:]
    ext = torch.cat([masks[..., :1], -torch.flip(masks[..., 1:], dims=[-1])], dim=-1)  # [S, k, N]
    half = 1 << (params.log_d - 1)
    n = params.n
    head = n if params.block else 0
    a_out = []
    for party, pk in enumerate(keys):
        digits = decomp(ext[:, party, params.big_n - params.ksk_coeffs:], params.f, params.log_d, 32)  # [S, C, f]
        c, f = digits.shape[1], digits.shape[2]
        base = (torch.arange(c, device=acc.device)[:, None] * f + torch.arange(f, device=acc.device)) * half
        idx = (base + digits.abs() - 1).clamp(min=0).reshape(digits.shape[0], -1)
        sign = digits.sign().reshape(digits.shape[0], -1)
        a_p = torch.zeros((acc.shape[0], n), dtype=torch.int64, device=acc.device)
        for g0 in range(0, acc.shape[0], chunk):
            rows = pk.ksk[idx[g0:g0 + chunk]].long()  # [c, C*f, 1 + n]
            tot = (rows * sign[g0:g0 + chunk, :, None]).sum(1)
            b[g0:g0 + chunk] += tot[:, 0]
            a_p[g0:g0 + chunk] = tot[:, 1:]
        if head:
            a_p = a_p + ext[:, party, :head]
        a_out.append(a_p)
    return wrap32(b), wrap32(torch.cat(a_out, dim=1))


def bootstrap(ring, params: KmsSet, b: torch.Tensor, a: torch.Tensor, seed: int, crs_polys: torch.Tensor,
              party_chunk: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The gate bootstrap of S ciphertexts (b [S], a [S, k*n] int32, after
    the gate's affine step), on keys made again from the seed (by `ring`
    where it is exact, else by a `MatrixRing`): phase 1 in
    chunks of parties (their keys made, transformed, used and dropped),
    phase 2, key switch.  Returns (b [S], a [S, k*n]) int32."""
    check_ranges(ring, params)
    n, k = params.big_n, params.k
    tildeb = mod_switch(b, n)
    tildea = mod_switch(a, n).reshape(a.shape[0], k, params.n).movedim(1, 0)  # [k, S, n]
    exact = ring if ring.exact else MatrixRing(n, b.device)
    levkeys = []
    for p0 in range(0, k, party_chunk):
        chunk = range(p0, min(k, p0 + party_chunk))
        pks = [party_keys(params, seed, p, crs_polys, exact, with_ksk=False) for p in chunk]
        hats = brk_hats(ring, pks)
        del pks
        levkeys.append(phase1(ring, params, tildea[p0:p0 + len(chunk)].contiguous(), hats))
        del hats
    levkeys = torch.cat(levkeys)
    keys = [party_keys(params, seed, p, crs_polys, exact, with_brk=False) for p in range(k)]
    acc = phase2(ring, params, tildeb, levkeys, keys, crs_polys)
    return keyswitch(params, acc, keys)
