"""A Python-int model of kernels Q and R as they run one row over a
thread-block cluster of C blocks (``csrc/cluster.cuh``, ``quotient.cu``,
``ring_commit.cu``), for the CPU tests.

It follows the kernels' stage order: the top log2 C DIF stages (and the last
log2 C DIT stages) as a cross-block radix-C exchange on the groups of words
p + r L (r < C), every other stage inside each block's chunk of L = m / C
words, the read-outs gathered in natural order from block rev(t mod C) at
position rev(t / C), twiddles from stage-major tables. Its fields are the
kernels' arithmetic: ``Canonical`` (Goldilocks, every word reduced) and
``Shoup`` (the 44-bit field's ``Q45Shoup``: Shoup products by known
constants, words in [0, 2q) after DIF stages and in [0, 4q) after DIT
stages), each asserting the range of every word it takes and gives. It
reads the plan's tables as the kernels do.
"""

from __future__ import annotations

M64 = (1 << 64) - 1


def rev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


class Canonical:
    """Canonical arithmetic mod q (kernels Q and R over Goldilocks)."""

    def __init__(self, q: int):
        self.q = q

    def _ok(self, *xs):
        assert all(0 <= x < self.q for x in xs), xs

    def dif(self, a, b, w, ws):
        self._ok(a, b)
        return (a + b) % self.q, (a - b) * w % self.q

    def dit(self, a, b, w, ws):
        self._ok(a, b)
        t = b * w % self.q
        return (a + t) % self.q, (a - t) % self.q

    def mul_tab(self, x, w, ws):
        self._ok(x)
        return x * w % self.q

    def canon2(self, x):
        self._ok(x)
        return x

    canon4 = canon2

    def mul(self, a, b):
        self._ok(a, b)
        return a * b % self.q

    def sub_lazy(self, x, y):
        self._ok(x, y)
        return (x - y) % self.q


class Shoup:
    """The 44-bit field as ``Q45Shoup`` runs it (``csrc/modmath.cuh``)."""

    def __init__(self, q: int):
        self.q, self.q2, self.q4 = q, 2 * q, 4 * q

    def mul_tw(self, x, w, ws):
        assert 0 <= x <= M64 and 0 <= w < self.q and ws == (w << 64) // self.q
        r = (x * w - ((x * ws) >> 64) * self.q) & M64
        assert r < self.q2 and r % self.q == x * w % self.q
        return r

    def dif(self, a, b, w, ws):
        assert 0 <= a < self.q2 and 0 <= b < self.q2, (a, b)
        s = a + b
        return (s - self.q2 if s >= self.q2 else s), self.mul_tw(a - b + self.q2, w, ws)

    def dit(self, a, b, w, ws):
        assert 0 <= a < self.q4 and 0 <= b < self.q4, (a, b)
        u = a - self.q2 if a >= self.q2 else a
        t = self.mul_tw(b, w, ws)
        hi, lo = u + t, u - t + self.q2
        assert hi < self.q4 and 0 < lo < self.q4
        return hi, lo

    mul_tab = mul_tw

    def canon2(self, x):
        assert 0 <= x < self.q2, x
        return x - self.q if x >= self.q else x

    def canon4(self, x):
        assert 0 <= x < self.q4, x
        return self.canon2(x - self.q2 if x >= self.q2 else x)

    def mul(self, a, b):
        assert 0 <= a < self.q and 0 <= b < self.q
        return a * b % self.q

    def sub_lazy(self, x, y):
        assert 0 <= x < self.q
        r = x + self.q - self.canon4(y)
        assert 0 < r < self.q2
        return r


def _comp(tws, idx):
    return tws[idx] if tws is not None else 0


def dif_stages(fld, e, tw, tws, lo, lo_bits, r):
    """butterfly.cuh's dif_stages<r>: words e[k] at lo + k 2^lo_bits,
    twiddles from stage-major tables (stage s's twiddle at j at 2^s + j)."""
    for sr in range(r - 1, -1, -1):
        half = 1 << sr
        for k in range(1 << r):
            if not k & half:
                idx = (1 << (lo_bits + sr)) + lo + ((k & (half - 1)) << lo_bits)
                e[k], e[k + half] = fld.dif(e[k], e[k + half], tw[idx], _comp(tws, idx))


def dit_stages(fld, e, tw, tws, lo, lo_bits, r):
    """butterfly.cuh's dit_stages<r>."""
    for sr in range(r):
        half = 1 << sr
        for k in range(1 << r):
            if not k & half:
                idx = (1 << (lo_bits + sr)) + lo + ((k & (half - 1)) << lo_bits)
                e[k], e[k + half] = fld.dit(e[k], e[k + half], tw[idx], _comp(tws, idx))


def local_stages(fld, x, tw, tws, dit):
    """Every stage of one block's chunk x (tile_stages), radix 2 in order:
    the passes group them by three, which changes no butterfly."""
    log_l = len(x).bit_length() - 1
    for s in (range(log_l) if dit else range(log_l - 1, -1, -1)):
        half = 1 << s
        for i0 in range(len(x)):
            if not i0 & half:
                idx = half + (i0 & (half - 1))
                op = fld.dit if dit else fld.dif
                x[i0], x[i0 + half] = op(x[i0], x[i0 + half], tw[idx], _comp(tws, idx))


class Cluster:
    """A row of m words over C blocks: chunks of L = m / C words."""

    def __init__(self, m: int, blocks: int):
        self.m, self.c = m, blocks
        self.log_m, self.kc = m.bit_length() - 1, blocks.bit_length() - 1
        self.log_l, self.L = self.log_m - self.kc, m // blocks
        assert self.L // blocks >= 1, "every block takes an exchange group"

    def tiles(self):
        return [[None] * self.L for _ in range(self.c)]

    def group(self, tiles, p):
        return [tiles[r][p] for r in range(self.c)]

    def put(self, tiles, p, words):
        for r in range(self.c):
            tiles[r][p] = words[r]

    def gather(self, tiles, t):
        """Frequency t of a DIF output spread over the blocks' chunks."""
        return tiles[rev(t % self.c, self.kc)][rev(t // self.c, self.log_l)]


def quotient_row(fld, tables, a, b, c, blocks):
    """Kernel Q on one row: (Q, A, B, C coefficients, valid)."""
    tw_inv, tw_inv_s, tw, tw_s, twist, twist_s, untwist, untwist_s, inv_m, inv_m_s = tables
    cl = Cluster(len(a), blocks)
    L, ll, kc = cl.L, cl.log_l, cl.kc
    bufs = [cl.tiles() for _ in range(3)]  # x (a, then N), y (b), z (c)
    valid = True
    for p in range(L):  # 1. a, b, c through their top DIF stages
        words = [[v[p + r * L] for r in range(cl.c)] for v in (a, b, c)]
        valid &= all(fld.mul(u, v) == w for u, v, w in zip(*words))
        for tiles, e in zip(bufs, words):
            dif_stages(fld, e, tw_inv, tw_inv_s, p, ll, kc)
            cl.put(tiles, p, e)
    for tiles in bufs:  # 2. local DIF stages
        for chunk in tiles:
            local_stages(fld, chunk, tw_inv, tw_inv_s, dit=False)
    coeffs = [[fld.canon2(fld.mul_tab(cl.gather(tiles, t), inv_m, inv_m_s))
               for t in range(cl.m)] for tiles in bufs]  # 3. A, B, C out
    for tiles in bufs:  # 4. the twist and the local DIT stages
        for r, chunk in enumerate(tiles):
            tiles[r] = [fld.mul_tab(v, twist[r * L + i], _comp(twist_s, r * L + i))
                        for i, v in enumerate(chunk)]
            local_stages(fld, tiles[r], tw, tw_s, dit=True)
    x = bufs[0]
    for p in range(L):  # 5. N = a_odd b_odd - c_odd through its top DIF stages
        ex, ey, ez = (cl.group(tiles, p) for tiles in bufs)
        for e in (ex, ey, ez):
            dit_stages(fld, e, tw, tw_s, p, ll, kc)
        n = [fld.sub_lazy(fld.mul(fld.canon4(u), fld.canon4(v)), w)
             for u, v, w in zip(ex, ey, ez)]
        dif_stages(fld, n, tw_inv, tw_inv_s, p, ll, kc)
        cl.put(x, p, n)
    for chunk in x:  # 6-7. local DIF stages, Q out
        local_stages(fld, chunk, tw_inv, tw_inv_s, dit=False)
    q_out = [fld.canon2(fld.mul_tab(cl.gather(x, t), untwist[t], _comp(untwist_s, t)))
             for t in range(cl.m)]
    return (q_out, *coeffs, valid)


def ring_commit_row(q, s_rows, e, msg, a_hat_rev, psi, psi_inv_n, tw, tw_inv, blocks):
    """Kernel R on one row: s_rows (k, n) and e (n,) small signed ints, msg
    (L <= n,) words; the commitment's n words."""
    fld = Canonical(q)
    embed = lambda v: v % q
    cl = Cluster(len(e), blocks)
    L, ll, kc = cl.L, cl.log_l, cl.kc
    x, acc = cl.tiles(), cl.tiles()
    for j, s in enumerate(s_rows):
        for p in range(L):  # embed(s_j) psi^t through the top DIF stages
            v = [fld.mul(embed(s[p + r * L]), psi[p + r * L]) for r in range(cl.c)]
            dif_stages(fld, v, tw, None, p, ll, kc)
            cl.put(x, p, v)
        for r, chunk in enumerate(x):  # local DIF stages; A_hat_j o x into acc
            local_stages(fld, chunk, tw, None, dit=False)
            for i, v in enumerate(chunk):
                prod = fld.mul(v, a_hat_rev[j][r * L + i])
                acc[r][i] = prod if j == 0 else (acc[r][i] + prod) % q
    for chunk in acc:
        local_stages(fld, chunk, tw_inv, None, dit=True)
    out = [None] * cl.m
    for p in range(L):  # the last DIT stages, then psi^-t / n, e and msg
        v = cl.group(acc, p)
        dit_stages(fld, v, tw_inv, None, p, ll, kc)
        for r in range(cl.c):
            i = p + r * L
            w = (fld.mul(v[r], psi_inv_n[i]) + embed(e[i])) % q
            out[i] = (w + msg[i]) % q if i < len(msg) else w
    return out
