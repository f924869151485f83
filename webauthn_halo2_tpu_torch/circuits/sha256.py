"""In-circuit SHA-256 (the gadget the reference's ES256 left unfinished).

The reference imports `halo2_dynamic_sha256` but never wires it up —
es256.rs:1 says "TODO: Fix SHA" and the module is disabled (SURVEY §2.1).
This chip completes the capability: bytewise SHA-256 over the vertical-gate
stack with two 16-bit paired lookup tables (8-bit XOR and AND), rotations
via witnessed piece-splits, and mod-2^32 additions via carry witnesses.

Words are carried in byte-decomposed form (4 little-endian byte cells);
bytes produced by pair lookups are range-constrained by the tables
themselves, so only freshly witnessed bytes pay an explicit range check.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import BN254_FR
from .builder import Cell, CircuitBuilder

R = BN254_FR

K_CONST = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
H_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


@dataclass
class U32:
    bytes: list[Cell]  # 4 cells, little-endian bytes in [0, 256)
    value: int  # integer value < 2^32


class Sha256Chip:
    def __init__(self, b: CircuitBuilder):
        self.b = b
        b.add_pair_table("xor8", lambda x, y: x ^ y)
        b.add_pair_table("and8", lambda x, y: x & y)

    # --- word plumbing ---------------------------------------------------
    def const_u32(self, v: int) -> U32:
        cells = [self.b.load_constant((v >> (8 * i)) & 255) for i in range(4)]
        return U32(cells, v)

    def witness_bytes(self, vals: list[int], check_range: bool = True
                     ) -> list[Cell]:
        cells = self.b.load_witnesses(vals)
        if check_range:
            for c in cells:
                self.b.range_check(c, 8)
        return cells

    def u32_from_bytes(self, byte_cells: list[Cell]) -> U32:
        v = sum(c.value << (8 * i) for i, c in enumerate(byte_cells))
        return U32(list(byte_cells), v)

    def compose(self, w: U32) -> Cell:
        """Full 32-bit value cell (recomposition constraint)."""
        return self.b.inner_product(w.bytes, [1, 1 << 8, 1 << 16, 1 << 24])

    def decompose_value(self, cell: Cell, value: int) -> U32:
        """Witness bytes for a full-value cell and tie them together."""
        bs = self.witness_bytes([(value >> (8 * i)) & 255 for i in range(4)])
        rec = self.b.inner_product(bs, [1, 1 << 8, 1 << 16, 1 << 24])
        self.b.assert_equal(rec, cell)
        return U32(bs, value)

    # --- bitwise ops via pair lookups ------------------------------------
    def _pairwise(self, name: str, fn, a: U32, c: U32) -> U32:
        b = self.b
        out_bytes = []
        out_val = 0
        for i in range(4):
            key_v = a.bytes[i].value + 256 * c.bytes[i].value
            cells = b.assign_region(
                [a.bytes[i].value, c.bytes[i].value, 256, key_v], [0]
            )
            b.copy(cells[0], a.bytes[i])
            b.copy(cells[1], c.bytes[i])
            b.constrain_constant(cells[2], 256)
            key = cells[3]
            res_v = fn(a.bytes[i].value, c.bytes[i].value)
            [val] = b.load_witnesses([res_v])
            b.pair_lookup(name, key, val)
            out_bytes.append(val)
            out_val |= res_v << (8 * i)
        return U32(out_bytes, out_val)

    def xor32(self, a: U32, c: U32) -> U32:
        return self._pairwise("xor8", lambda x, y: x ^ y, a, c)

    def and32(self, a: U32, c: U32) -> U32:
        return self._pairwise("and8", lambda x, y: x & y, a, c)

    def not32(self, a: U32) -> U32:
        b = self.b
        out_bytes = []
        for i in range(4):
            ob = (~a.bytes[i].value) & 255
            cells = b.assign_region([ob, a.bytes[i].value, 1, 255], [0])
            b.copy(cells[1], a.bytes[i])
            b.constrain_constant(cells[2], 1)
            b.constrain_constant(cells[3], 255)
            out_bytes.append(cells[0])
        return U32(out_bytes, (~a.value) & 0xFFFFFFFF)

    # --- modular addition -------------------------------------------------
    def add32(self, words: list[U32], const: int = 0) -> U32:
        """(sum words + const) mod 2^32 with a carry witness."""
        b = self.b
        total = sum(w.value for w in words) + const
        out_v = total & 0xFFFFFFFF
        carry = total >> 32
        assert carry < 16
        avs, bvs = [], []
        for w in words:
            for i, byte in enumerate(w.bytes):
                avs.append(byte)
                bvs.append(1 << (8 * i))
        out = self.witness_bytes([(out_v >> (8 * i)) & 255 for i in range(4)])
        for i, byte in enumerate(out):
            avs.append(byte)
            bvs.append((-(1 << (8 * i))) % R)
        [k] = b.load_witnesses([carry])
        b.range_check(k, 4)
        avs.append(k)
        bvs.append((-(1 << 32)) % R)
        ip = b.inner_product(avs, bvs)
        s = b.add_const(ip, const)
        b.assert_zero(s)
        return U32(out, out_v)

    # --- sigma functions (rotation piece-splits) --------------------------
    def _split_rotate(self, w: U32, cuts: list[int], rots: list[int],
                      shifts: list[int]) -> list[U32]:
        """Split w at bit positions `cuts`; return the words rotr(w, r) for
        r in rots followed by (w >> s) for s in shifts."""
        b = self.b
        bounds = [0] + sorted(cuts) + [32]
        pieces = []
        sizes = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sizes.append(hi - lo)
            pieces.append((w.value >> lo) & ((1 << (hi - lo)) - 1))
        pcells = b.load_witnesses(pieces)
        for c, sz in zip(pcells, sizes):
            b.range_check(c, sz)
        # recomposition == w
        rec = b.inner_product(pcells, [1 << lo for lo in bounds[:-1]])
        full = self.compose(w)
        b.assert_equal(rec, full)

        outs = []
        for r in rots:
            # rotr(w, r): piece at [lo, hi) lands at (lo - r) mod 32
            coefs = []
            val = ((w.value >> r) | (w.value << (32 - r))) & 0xFFFFFFFF
            for lo in bounds[:-1]:
                coefs.append(1 << ((lo - r) % 32))
            cell = b.inner_product(pcells, coefs)
            outs.append(self.decompose_value(cell, val))
        for s in shifts:
            coefs = []
            val = w.value >> s
            for lo, sz in zip(bounds[:-1], sizes):
                coefs.append((1 << (lo - s)) if lo >= s else 0)
            cell = b.inner_product(pcells, coefs)
            outs.append(self.decompose_value(cell, val))
        return outs

    def big_sigma0(self, a: U32) -> U32:
        r1, r2, r3 = self._split_rotate(a, [2, 13, 22], [2, 13, 22], [])
        return self.xor32(self.xor32(r1, r2), r3)

    def big_sigma1(self, e: U32) -> U32:
        r1, r2, r3 = self._split_rotate(e, [6, 11, 25], [6, 11, 25], [])
        return self.xor32(self.xor32(r1, r2), r3)

    def small_sigma0(self, w: U32) -> U32:
        r1, r2, s1 = self._split_rotate(w, [3, 7, 18], [7, 18], [3])
        return self.xor32(self.xor32(r1, r2), s1)

    def small_sigma1(self, w: U32) -> U32:
        r1, r2, s1 = self._split_rotate(w, [10, 17, 19], [17, 19], [10])
        return self.xor32(self.xor32(r1, r2), s1)

    # --- the compression function ----------------------------------------
    def compress(self, state: list[U32], block: list[U32]) -> list[U32]:
        w = list(block)
        for t in range(16, 64):
            w.append(
                self.add32([
                    self.small_sigma1(w[t - 2]), w[t - 7],
                    self.small_sigma0(w[t - 15]), w[t - 16],
                ])
            )
        a, bb, c, d, e, f, g, h = state
        for t in range(64):
            ch = self.xor32(self.and32(e, f), self.and32(self.not32(e), g))
            t1 = self.add32([h, self.big_sigma1(e), ch, w[t]], K_CONST[t])
            maj = self.xor32(
                self.xor32(self.and32(a, bb), self.and32(a, c)),
                self.and32(bb, c),
            )
            t2 = self.add32([self.big_sigma0(a), maj])
            h, g, f = g, f, e
            e = self.add32([d, t1])
            d, c, bb = c, bb, a
            a = self.add32([t1, t2])
        out = [a, bb, c, d, e, f, g, h]
        return [self.add32([s, o]) for s, o in zip(state, out)]

    def sha256(self, msg_bytes: list[Cell], length: int) -> list[Cell]:
        """SHA-256 of a fixed-length byte-cell message -> 32 BE byte cells.

        Padding bytes are circuit constants (length is static).
        """
        b = self.b
        assert len(msg_bytes) == length
        padded: list[Cell] = list(msg_bytes)
        padded.append(b.load_constant(0x80))
        while (len(padded) + 8) % 64:
            padded.append(b.load_constant(0))
        bitlen = 8 * length
        for i in range(7, -1, -1):
            padded.append(b.load_constant((bitlen >> (8 * i)) & 255))

        state = [self.const_u32(v) for v in H_INIT]
        for off in range(0, len(padded), 64):
            blk = padded[off : off + 64]
            words = []
            for i in range(16):
                # big-endian word from 4 bytes
                be = blk[4 * i : 4 * i + 4]
                word_bytes = [be[3], be[2], be[1], be[0]]  # little-endian
                words.append(self.u32_from_bytes(word_bytes))
            state = self.compress(state, words)
        out = []
        for wd in state:
            out.extend([wd.bytes[3], wd.bytes[2], wd.bytes[1], wd.bytes[0]])
        return out
