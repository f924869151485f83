"""The plain reference that decides `correct`: the circuit's description,
its verifying key, a witness check and a proof verifier, in Python ints.

It imports nothing of the program. The configuration file states the
circuit: the flex-gate layout (`num_advice` gate columns, each with the
vertical gate q_i * (a_i + a_i(wX) a_i(w^2 X) - a_i(w^3 X)), `num_lookup_advice`
columns range-checked against a table [0, 2^lookup_bits), a constants
column, every advice column and the constants column under copy
constraints), k, the SRS seed, and the digest of its synthesis as the JAX
package computed it.

From the layout (selectors, constants and copies, which the program's
synthesis makes and `layout_digest` holds against that digest) the
reference works out the verifying key again: every fixed and permutation
commitment as [p(tau)]G1, where p(tau) = sum_i p_i L_i(tau) and tau is the
SRS's dev tau, derived from its seed. Knowing tau also turns the final
pairing of a KZG opening into a check in G1: e(L, G2) = e(W, tau G2)
exactly when L = tau W.

It also says which valid signatures the circuit has no witness for
(`in_domain`), where a run expects the program's witness to fail.
"""
from __future__ import annotations

import hashlib
import operator

import numpy as np

from .plain import (BN_G1, BN_G1_CURVE, BN_Q, BN_R, FR_DELTA, P256, P256_G, P256_N, batch_inv,
                    root_of_unity)

R = BN_R
G = BN_G1_CURVE
ADVICE, FIXED = "advice", "fixed"


def derive_tau(seed: bytes) -> int:
    """The dev SRS's tau: Blake2b-512 of a fixed label and the seed, mod r
    (the published derivation of the project's development SRS; not a
    trusted setup)."""
    h = hashlib.blake2b(b"webauthn-halo2-tpu/dev-srs/" + seed, digest_size=64)
    return int.from_bytes(h.digest(), "little") % R


def _var(kind: str, index: int, rot: int = 0) -> str:
    return f"Var(kind='{kind}', index={index}, rotation={rot})"


class Circuit:
    """The flex-gate constraint system the configuration states."""

    def __init__(self, k: int, num_advice: int, num_lookup_advice: int, lookup_bits: int):
        self.k, self.n = k, 1 << k
        self.na, self.nl, self.lookup_bits = num_advice, num_lookup_advice, lookup_bits
        self.num_fixed = num_advice + 2  # selectors, constants, table
        self.num_advice = num_advice + num_lookup_advice
        self.table_col = num_advice + 1
        self.perm_columns = [(ADVICE, i) for i in range(self.num_advice)] + [(FIXED, num_advice)]
        # gates are degree 3; the lookup and the permutation arguments make it 4
        self.degree = 4
        self.chunk_len = self.degree - 2
        self.nchunks = -(-len(self.perm_columns) // self.chunk_len)
        self.extended_k = k + 2  # 2^2 >= degree - 1
        # four rotations of a gate column, plus the boundary and one spare row
        self.blinding = max(3, 4 if num_advice else 1) + 2
        self.usable = self.n - (self.blinding + 1)
        self.advice_queries = sorted(
            [(i, r) for i in range(num_advice) for r in range(4)]
            + [(num_advice + j, 0) for j in range(num_lookup_advice)])
        self.fixed_queries = [(i, 0) for i in range(self.num_fixed)]

    def gate_strings(self) -> list:
        minus1 = R - 1
        out = []
        for i in range(self.na):
            a = [_var(ADVICE, i, r) for r in range(4)]
            out.append((f"vgate{i}",
                        f"Prod(a={_var(FIXED, i)}, b=Sum(a=Sum(a={a[0]}, b=Prod(a={a[1]}, "
                        f"b={a[2]})), b=Scaled(a={a[3]}, c={minus1})))"))
        return out

    def lookup_strings(self) -> list:
        return [(f"range{j}", [_var(ADVICE, self.na + j)], [_var(FIXED, self.table_col)])
                for j in range(self.nl)]

    def cs_repr(self, with_degree: bool) -> bytes:
        body = (self.num_fixed, self.num_advice, 0, self.gate_strings(),
                self.lookup_strings(), self.perm_columns)
        return repr(((self.degree,) + body) if with_degree else body).encode()


def _words(vals) -> bytes:
    """Values mod r as eight little-endian 32-bit words each, word-major
    (word 0 of every value, then word 1, ...)."""
    raw = b"".join((int(v) % R).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(len(vals), 8).T.tobytes()


def layout_digest(circ: Circuit, fixed: list, advice: list, copies: list) -> str:
    """Blake2b-256 of one synthesis: the constraint system, each fixed and
    advice column (its length and words) and the copies, as the project's
    synthesis digest defines it."""
    h = hashlib.blake2b(digest_size=32)
    h.update(circ.cs_repr(with_degree=True))
    for col in list(fixed) + list(advice):
        h.update(len(col).to_bytes(4, "little"))
        h.update(_words(col))
    h.update(repr(copies).encode())
    return h.hexdigest()


def compress(pt) -> bytes:
    if pt is None:
        return bytes(32)
    b = bytearray(pt[0].to_bytes(32, "little"))
    if pt[1] & 1:
        b[31] |= 0x80
    return bytes(b)


class VerifyingKey:
    def __init__(self, circ, fixed_commitments, perm_commitments, transcript_repr):
        self.circ = circ
        self.fixed_commitments = fixed_commitments
        self.perm_commitments = perm_commitments
        self.transcript_repr = transcript_repr


def lagrange_at(k: int, tau: int) -> list:
    """L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i)) for i < 2^k."""
    n = 1 << k
    w = root_of_unity(k)
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % R
    zh = (pow(tau, n, R) - 1) % R
    scale = zh * pow(n, R - 2, R) % R
    inv = batch_inv([(tau - wi) % R for wi in wpow], R)
    return [wi * d % R * scale % R for wi, d in zip(wpow, inv)]


def permutation_targets(circ: Circuit, copies: list) -> list:
    """Each permutation cell's (column, row) target, column-major and flat:
    the identity, then the targets of the two cells of each copy swapped,
    in the copies' order (the order defines the key's sigma polynomials)."""
    n = circ.n
    pos = {c: i for i, c in enumerate(circ.perm_columns)}
    target = list(range(len(circ.perm_columns) * n))
    for (ka, ia, ra), (kb, ib, rb) in copies:
        a = pos[(ka, ia)] * n + ra
        b = pos[(kb, ib)] * n + rb
        target[a], target[b] = target[b], target[a]
    return target


def verifying_key(circ: Circuit, fixed: list, copies: list, tau: int) -> VerifyingKey:
    """The circuit's verifying key, from its layout and tau."""
    n = circ.n
    lag = lagrange_at(circ.k, tau)

    def commit(vals) -> tuple:
        return G.mul(sum(map(operator.mul, vals, lag)) % R, BN_G1)

    fixed_comms = [commit([int(v) for v in col] + [0] * (n - len(col))) for col in fixed]
    w = root_of_unity(circ.k)
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % R
    dpow = [pow(FR_DELTA, j, R) for j in range(len(circ.perm_columns))]
    target = permutation_targets(circ, copies)
    perm_comms = []
    for j in range(len(circ.perm_columns)):
        sig = [dpow[t // n] * wpow[t % n] % R for t in target[j * n:(j + 1) * n]]
        perm_comms.append(commit(sig))
    h = hashlib.blake2b(digest_size=64, person=b"WH2-TPU-vk")
    h.update(circ.k.to_bytes(4, "little"))
    h.update(circ.extended_k.to_bytes(4, "little"))
    h.update(circ.cs_repr(with_degree=False))
    for c in fixed_comms + perm_comms:
        h.update(compress(c))
    return VerifyingKey(circ, fixed_comms, perm_comms, int.from_bytes(h.digest(), "little") % R)


def vk_mismatches(ref: VerifyingKey, fixed_commitments, perm_commitments, transcript_repr) -> int:
    """Entries of a program's verifying key that differ from the reference's."""
    bad = int(len(fixed_commitments) != len(ref.fixed_commitments))
    bad += int(len(perm_commitments) != len(ref.perm_commitments))
    bad += sum(tuple(a) != tuple(b) for a, b in zip(fixed_commitments, ref.fixed_commitments))
    bad += sum(tuple(a) != tuple(b) for a, b in zip(perm_commitments, ref.perm_commitments))
    return bad + int(transcript_repr != ref.transcript_repr)


# ---------------------------------------------------------------------------
# the witness
# ---------------------------------------------------------------------------

def limbs88(x: int) -> list:
    return [(x >> (88 * i)) & ((1 << 88) - 1) for i in range(3)]


def witness_faults(circ: Circuit, fixed: list, copies: list, advice: list,
                   instances: list, inputs: dict, request: dict) -> int:
    """Constraints a witness breaks: columns past the usable rows, gates,
    range lookups, copies, public inputs (the configuration states none),
    and cells that should carry the request's inputs (88-bit limbs at the
    cells the configuration names) but do not."""
    if len(advice) != circ.num_advice:
        return 1 + abs(len(advice) - circ.num_advice)
    faults = sum(len(col) > circ.usable for col in advice) + len(instances)
    for i in range(circ.na):
        col, sel = advice[i], fixed[i]
        m = len(col)

        def at(r, col=col, m=m):
            return col[r] if r < m else 0

        for r, q in enumerate(sel):
            if q and (at(r) + at(r + 1) * at(r + 2) - at(r + 3)) % R:
                faults += 1
    bound = 1 << circ.lookup_bits
    for j in range(circ.nl):
        faults += sum(not 0 <= v < bound for v in advice[circ.na + j])

    def value(ref):
        kind, c, r = ref
        col = advice[c] if kind == ADVICE else fixed[c]
        return col[r] if r < len(col) else 0

    faults += sum(value(a) % R != value(b) % R for a, b in copies)
    for name, cells in inputs.items():
        want = limbs88(int.from_bytes(bytes(request[name]), "little"))
        faults += sum(value((ADVICE, c, r)) != v for (c, r), v in zip(cells, want))
    return faults


# ---------------------------------------------------------------------------
# the circuit's domain: the valid signatures it has a witness for
# ---------------------------------------------------------------------------

# the circuit's scalar multiplications (4-bit windows, each digit offset by
# one): u is decomposed as u' = u - C0 mod n into 64 digits
WINDOWS = 64
C0 = ((1 << 256) - 1) // 15


def _window_digits(u: int) -> list:
    v = (u - C0) % P256_N
    return [(v >> (4 * w)) & 15 for w in range(WINDOWS)]


def _meets(a: int, b: int) -> bool:
    """Whether the points a P and b P (P of order n) share an x: a = +-b."""
    return (a - b) % P256_N == 0 or (a + b) % P256_N == 0


def in_domain(req: dict) -> bool:
    """Whether the circuit has a witness for a request's valid signature:
    its incomplete additions (a division by x2 - x1) never meet two points
    with one x. The fixed-base product u1 G adds (d_w + 1) 16^w G window by
    window; the variable-base one u2 Q doubles four times and adds
    (d_w + 1) Q, from the top window down; last u1 G and u2 Q are added.
    About one signature in 137 falls outside: a first window of 15 and a
    second of 0 in u1' (16 G + 16 G), or a top window of 0 and a next of 15
    in u2' (16 Q + 16 Q), and longer such runs. The program's witness
    raises ValueError on those; a run expects that error there and only
    there."""
    r, s, x, y, m = (int.from_bytes(bytes(req[k]), "little")
                     for k in ("r", "s", "pubkey_x", "pubkey_y", "msghash"))
    w = pow(s, -1, P256_N)
    u1, u2 = m * w % P256_N, r * w % P256_N
    d = _window_digits(u1)
    acc = d[0] + 1
    for i in range(1, WINDOWS):
        t = (d[i] + 1) << (4 * i)
        if _meets(acc, t):
            return False
        acc += t
    d = _window_digits(u2)
    acc = d[-1] + 1
    for i in range(WINDOWS - 2, -1, -1):
        acc = (acc << 4) % P256_N
        if acc == 0 or _meets(acc, d[i] + 1):
            return False
        acc += d[i] + 1
    p1, p2 = P256.mul(u1, P256_G), P256.mul(u2, (x, y))
    return p1 is not None and p2 is not None and p1[0] != p2[0]


# ---------------------------------------------------------------------------
# the proof: SHPLONK over a Blake2b transcript
# ---------------------------------------------------------------------------

class Transcript:
    """The Halo2 Blake2b transcript read back: personal "Halo2-Transcript",
    prefixes 0 (challenge), 1 (point), 2 (scalar); points travel as 32-byte
    little-endian x with the parity of y in the top bit."""

    def __init__(self, proof: bytes):
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self.proof, self.off = proof, 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.proof):
            raise ValueError("proof too short")
        self.off += n
        return self.proof[self.off - n:self.off]

    def common_point(self, pt) -> None:
        x, y = (0, 0) if pt is None else pt
        self.state.update(b"\x01" + x.to_bytes(32, "little") + y.to_bytes(32, "little"))

    def common_scalar(self, s: int) -> None:
        self.state.update(b"\x02" + (s % R).to_bytes(32, "little"))

    def squeeze(self) -> int:
        self.state.update(b"\x00")
        return int.from_bytes(self.state.copy().digest(), "little") % R

    def read_point(self):
        raw = bytearray(self._take(32))
        if raw == bytes(32):
            pt = None
        else:
            odd = bool(raw[31] & 0x80)
            raw[31] &= 0x7F
            x = int.from_bytes(bytes(raw), "little")
            if x >= BN_Q:
                raise ValueError("non-canonical point")
            pt = G.lift_x(x, odd)
            if pt is None:
                raise ValueError("point not on the curve")
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(32), "little")
        if s >= R:
            raise ValueError("non-canonical scalar")
        self.common_scalar(s)
        return s


def verify(vk: VerifyingKey, proof: bytes, tau: int) -> bool:
    try:
        return _verify(vk, proof, tau)
    except (ValueError, ZeroDivisionError):
        return False


def _inv(v: int) -> int:
    if v % R == 0:
        raise ZeroDivisionError
    return pow(v, R - 2, R)


def _verify(vk: VerifyingKey, proof: bytes, tau: int) -> bool:
    c = vk.circ
    n, u = c.n, c.usable
    omega = root_of_unity(c.k)
    t = Transcript(proof)
    t.common_scalar(vk.transcript_repr)
    advice_coms = [t.read_point() for _ in range(c.num_advice)]
    theta = t.squeeze()
    lk_perm = [(t.read_point(), t.read_point()) for _ in range(c.nl)]
    beta, gamma = t.squeeze(), t.squeeze()
    perm_z = [t.read_point() for _ in range(c.nchunks)]
    lk_z = [t.read_point() for _ in range(c.nl)]
    random_com = t.read_point()
    y = t.squeeze()
    h_coms = [t.read_point() for _ in range(c.degree - 1)]
    x = t.squeeze()

    ev: dict = {}
    queries = []

    def rd(label, rot):
        v = t.read_scalar()
        ev[(label, rot)] = v
        queries.append((label, rot, v))
        return v

    for i, rot in c.advice_queries:
        rd((ADVICE, i), rot)
    for i, rot in c.fixed_queries:
        rd((FIXED, i), rot)
    rd(("random",), 0)
    for j in range(len(c.perm_columns)):
        rd(("sigma", j), 0)
    for i in range(c.nchunks):
        rd(("perm_z", i), 0)
        rd(("perm_z", i), 1)
    for i in range(c.nchunks - 1):
        rd(("perm_z", i), u)
    for j in range(c.nl):
        rd(("lookup_z", j), 0)
        rd(("lookup_z", j), 1)
        rd(("lookup_ap", j), 0)
        rd(("lookup_ap", j), -1)
        rd(("lookup_sp", j), 0)

    xn = pow(x, n, R)
    zh = (xn - 1) % R

    def lagrange(i: int) -> int:
        wi = pow(omega, i, R)
        return wi * zh % R * _inv(n * (x - wi)) % R

    l0, llast = lagrange(0), lagrange(u)
    lblind = sum(lagrange(i) for i in range(u + 1, n)) % R
    active = (1 - llast - lblind) % R

    def a(i, rot=0):
        return ev[((ADVICE, i), rot)]

    def f(i):
        return ev[((FIXED, i), 0)]

    cons = [f(i) * (a(i) + a(i, 1) * a(i, 2) - a(i, 3)) % R for i in range(c.na)]
    z = [ev[(("perm_z", i), 0)] for i in range(c.nchunks)]
    cons.append(l0 * (1 - z[0]) % R)
    cons.append(llast * (z[-1] * z[-1] - z[-1]) % R)
    for i in range(1, c.nchunks):
        cons.append(l0 * (z[i] - ev[(("perm_z", i - 1), u)]) % R)
    for ci in range(c.nchunks):
        left, right = ev[(("perm_z", ci), 1)], z[ci]
        for j in range(ci * c.chunk_len, min((ci + 1) * c.chunk_len, len(c.perm_columns))):
            kind, idx = c.perm_columns[j]
            v = a(idx) if kind == ADVICE else f(idx)
            left = left * (v + beta * ev[(("sigma", j), 0)] + gamma) % R
            right = right * (v + beta * pow(FR_DELTA, j, R) % R * x + gamma) % R
        cons.append(active * (left - right) % R)
    for j in range(c.nl):
        lz, lzn = ev[(("lookup_z", j), 0)], ev[(("lookup_z", j), 1)]
        ap, ap_prev = ev[(("lookup_ap", j), 0)], ev[(("lookup_ap", j), -1)]
        sp = ev[(("lookup_sp", j), 0)]
        inp, tab = a(c.na + j), f(c.table_col)
        cons.append(l0 * (1 - lz) % R)
        cons.append(llast * (lz * lz - lz) % R)
        lhs = lzn * (ap + beta) % R * (sp + gamma) % R
        rhs = lz * (inp + beta) % R * (tab + gamma) % R
        cons.append(active * (lhs - rhs) % R)
        cons.append(active * (ap - sp) % R * (ap - ap_prev) % R)
        cons.append(l0 * (ap - sp) % R)
    h_eval = 0
    for v in cons:
        h_eval = (h_eval * y + v) % R
    h_eval = h_eval * _inv(zh) % R

    com = {(ADVICE, i): advice_coms[i] for i in range(c.num_advice)}
    com.update({(FIXED, i): vk.fixed_commitments[i] for i in range(c.num_fixed)})
    com[("random",)] = random_com
    com.update({("sigma", j): vk.perm_commitments[j] for j in range(len(c.perm_columns))})
    com.update({("perm_z", i): perm_z[i] for i in range(c.nchunks)})
    for j in range(c.nl):
        com[("lookup_z", j)] = lk_z[j]
        com[("lookup_ap", j)], com[("lookup_sp", j)] = lk_perm[j]
    com[("h",)] = G.msm([(hc, pow(xn, i, R)) for i, hc in enumerate(h_coms)], R)
    queries.append((("h",), 0, h_eval))

    def point(rot: int) -> int:
        return x * pow(omega, rot, R) % R if rot >= 0 else x * _inv(pow(omega, -rot, R)) % R

    # SHPLONK: polynomials grouped by their set of rotations, sets in order
    by_poly: dict = {}
    for label, rot, v in queries:
        by_poly.setdefault(label, {})[rot] = v
    sets: dict = {}
    for label, rmap in by_poly.items():
        sets.setdefault(tuple(sorted(rmap)), []).append((label, rmap))
    set_list = sorted(sets.items(), key=lambda kv: kv[0])
    y2, v2 = t.squeeze(), t.squeeze()
    h2 = t.read_point()
    u2 = t.squeeze()
    w2 = t.read_point()
    if t.off != len(proof):
        raise ValueError("trailing proof bytes")
    zt = 1
    for p_ in {point(r) for rkey, _ in set_list for r in rkey}:
        zt = zt * (u2 - p_) % R
    pairs, g_scalar = [], 0
    S = len(set_list)
    for si, (rkey, polys) in enumerate(set_list):
        ypow = pow(y2, S - 1 - si, R)
        pts = [point(r) for r in rkey]
        zs = 1
        for p_ in pts:
            zs = zs * (u2 - p_) % R
        scale = ypow * zt % R * _inv(zs) % R
        for pi, (label, _) in enumerate(polys):
            pairs.append((com[label], scale * pow(v2, len(polys) - 1 - pi, R) % R))
        r_u = 0  # the set's interpolant of the v-folded evaluations, at u
        for jj, rj in enumerate(rkey):
            fold = 0
            for _, rmap in polys:
                fold = (fold * v2 + rmap[rj]) % R
            basis = 1
            for mm, pm in enumerate(pts):
                if mm != jj:
                    basis = basis * (u2 - pm) % R * _inv(pts[jj] - pm) % R
            r_u = (r_u + fold * basis) % R
        g_scalar = (g_scalar - scale * r_u) % R
    pairs += [(h2, (-zt) % R), (BN_G1, g_scalar), (w2, u2), (w2, (-tau) % R)]
    # e(L + u W, G2) = e(W, tau G2)  <=>  L + u W - tau W = 0
    return G.msm(pairs, R) is None
