"""EVM verifier codegen: vk -> straight-line Yul (+ Solidity wrapper).

The port's copy of the JAX package's evm/codegen.py: the VerifyingKey
is the port's (plonk/keygen.py), the SRS the port's (plonk/srs.py).

The `generate_verifier` equivalent (ecdsa_p256.rs:275-327 / snark-verifier
EvmLoader): emits an on-chain verifier for GWC + Keccak-transcript proofs
(the `prove_evm` output). Like the reference's generator, the verification
arithmetic is traced into Yul with all vk constants baked in as literals;
our trace is *fully straight-line* (every loop unrolled at codegen time,
every memory offset static), which keeps both the EVM bytecode simple and
the local dry-run interpreter (yul_interp.py — the revm-parity conformance
check, SURVEY §4.4) trivial to make exact.

Calldata convention: the raw proof bytes ARE the calldata (the account
calls `verifier.call(userOp.signature)` — P256Account.sol:78; the
reference's Yul also reads raw calldata). Returns (0, 0) on success,
reverts otherwise.
"""
from __future__ import annotations

from ..fields.constants import BN254_FQ, BN254_FR, BN254_FR_DELTA
from ..plonk import cs as CS
from ..plonk.keygen import VerifyingKey

R = BN254_FR
Q = BN254_FQ


class Emitter:
    def __init__(self):
        self.lines: list[str] = []
        self._tmp = 0

    def line(self, s: str) -> None:
        self.lines.append(s)

    def let(self, expr: str, name: str | None = None) -> str:
        v = name or f"v{self._tmp}"
        self._tmp += 1
        self.lines.append(f"let {v} := {expr}")
        return v

    # field helpers (mod R)
    def addf(self, a, b):
        return self.let(f"addmod({a}, {b}, R_MOD)")

    def subf(self, a, b):
        return self.let(f"addmod({a}, sub(R_MOD, {b}), R_MOD)")

    def mulf(self, a, b):
        return self.let(f"mulmod({a}, {b}, R_MOD)")


def _fmt(v: int) -> str:
    return hex(v)


class VerifierCodegen:
    """Walks the verification procedure symbolically, mirroring
    plonk/verifier.py step for step (same transcript, same GWC check)."""

    # static memory map
    BUF = 0x80          # transcript buffer start
    SCRATCH = 0x4000    # precompile scratch
    EC_ACC = 0x4100     # running ec accumulator (x, y)
    PAIR_IN = 0x4200    # pairing input (384 bytes)

    def __init__(self, vk: VerifyingKey, srs, num_public: int = 0,
                 scheme: str = "gwc"):
        self.vk = vk
        self.srs = srs
        self.num_public = num_public  # public-input words before the proof
        self.scheme = scheme  # "gwc" | "shplonk" (~33 fewer ecMuls: one
        # scalar per DISTINCT commitment instead of one per query)
        self.e = Emitter()
        self.buf_len = 0  # current transcript buffer length (static)
        self.cd_off = 0   # calldata offset (static)
        self.n_challenges = 0

    # --- transcript (KeccakBase semantics, static offsets) ---------------
    def absorb_words(self, exprs: list[str]) -> None:
        e = self.e
        for ex in exprs:
            e.line(f"mstore({_fmt(self.BUF + self.buf_len)}, {ex})")
            self.buf_len += 32

    def squeeze(self) -> str:
        e = self.e
        d = e.let(f"keccak256({_fmt(self.BUF)}, {_fmt(self.buf_len)})")
        e.line(f"mstore({_fmt(self.BUF)}, {d})")
        self.buf_len = 32
        c = e.let(f"mod({d}, R_MOD)", f"ch{self.n_challenges}")
        self.n_challenges += 1
        return c

    # --- proof stream -----------------------------------------------------
    def read_point(self) -> tuple[str, str]:
        e = self.e
        x = e.let(f"calldataload({_fmt(self.cd_off)})")
        y = e.let(f"calldataload({_fmt(self.cd_off + 32)})")
        self.cd_off += 64
        # canonical + on-curve (validate_ec_point parity, P256Verifier.yul:19)
        e.line(f"if iszero(lt({x}, Q_MOD)) {{ revert(0, 0) }}")
        e.line(f"if iszero(lt({y}, Q_MOD)) {{ revert(0, 0) }}")
        lhs = e.let(f"mulmod({y}, {y}, Q_MOD)")
        x2 = e.let(f"mulmod({x}, {x}, Q_MOD)")
        rhs = e.let(f"addmod(mulmod({x2}, {x}, Q_MOD), 3, Q_MOD)")
        e.line(f"if iszero(eq({lhs}, {rhs})) {{ revert(0, 0) }}")
        self.absorb_words([x, y])
        return x, y

    def read_scalar(self) -> str:
        e = self.e
        s = e.let(f"calldataload({_fmt(self.cd_off)})")
        self.cd_off += 32
        e.line(f"if iszero(lt({s}, R_MOD)) {{ revert(0, 0) }}")
        self.absorb_words([s])
        return s

    # --- ec precompiles ---------------------------------------------------
    def ec_mul(self, pt: tuple[str, str], scalar: str) -> tuple[str, str]:
        e = self.e
        S = self.SCRATCH
        e.line(f"mstore({_fmt(S)}, {pt[0]})")
        e.line(f"mstore({_fmt(S + 32)}, {pt[1]})")
        e.line(f"mstore({_fmt(S + 64)}, {scalar})")
        e.line(
            f"if iszero(staticcall(gas(), 7, {_fmt(S)}, 96, {_fmt(S)}, 64))"
            " { revert(0, 0) }"
        )
        return e.let(f"mload({_fmt(S)})"), e.let(f"mload({_fmt(S + 32)})")

    def ec_add(self, a: tuple[str, str], b: tuple[str, str]) -> tuple[str, str]:
        e = self.e
        S = self.SCRATCH
        e.line(f"mstore({_fmt(S)}, {a[0]})")
        e.line(f"mstore({_fmt(S + 32)}, {a[1]})")
        e.line(f"mstore({_fmt(S + 64)}, {b[0]})")
        e.line(f"mstore({_fmt(S + 96)}, {b[1]})")
        e.line(
            f"if iszero(staticcall(gas(), 6, {_fmt(S)}, 128, {_fmt(S)}, 64))"
            " { revert(0, 0) }"
        )
        return e.let(f"mload({_fmt(S)})"), e.let(f"mload({_fmt(S + 32)})")

    def finv(self, a: str) -> str:
        """Modular inverse via the modexp precompile (0x05), a^(R-2)."""
        e = self.e
        S = self.SCRATCH
        e.line(f"mstore({_fmt(S)}, 32)")
        e.line(f"mstore({_fmt(S + 32)}, 32)")
        e.line(f"mstore({_fmt(S + 64)}, 32)")
        e.line(f"mstore({_fmt(S + 96)}, {a})")
        e.line(f"mstore({_fmt(S + 128)}, {_fmt(R - 2)})")
        e.line(f"mstore({_fmt(S + 160)}, R_MOD)")
        e.line(
            f"if iszero(staticcall(gas(), 5, {_fmt(S)}, 192, {_fmt(S)}, 32))"
            " { revert(0, 0) }"
        )
        return e.let(f"mload({_fmt(S)})")

    def batch_inv(self, dens: list[str]) -> list[str]:
        """Montgomery-trick batch inversion: ONE modexp staticcall for all
        denominators (reference pattern: P256Verifier.yul:358) instead of
        one per inversion."""
        e = self.e
        prefix = [dens[0]]
        for d in dens[1:]:
            prefix.append(e.mulf(prefix[-1], d))
        acc = self.finv(prefix[-1])
        invs: list[str | None] = [None] * len(dens)
        for i in range(len(dens) - 1, 0, -1):
            invs[i] = e.mulf(acc, prefix[i - 1])
            acc = e.mulf(acc, dens[i])
        invs[0] = acc
        return invs  # type: ignore[return-value]

    def _emit_constraints(self, evals, theta, beta, gamma, y_ch, x_ch,
                          l0, llast, active) -> str:
        """Gate + permutation + lookup constraints folded with y; returns
        the quotient numerator (caller divides by Z_H)."""
        e = self.e
        cs = self.vk.cs
        nchunks = cs.num_perm_chunks()
        u = cs.usable_rows(self.vk.domain.n)

        def get_var(kind, idx, rot):
            return evals[((kind, idx), rot)]

        constraints: list[str] = []
        for _, g in cs.gates:
            constraints.append(
                g.eval(
                    get_var,
                    lambda c: _fmt(c % R),
                    lambda a, b: e.addf(a, b),
                    lambda a, b: e.mulf(a, b),
                    lambda a, c: e.mulf(a, _fmt(c % R)),
                )
            )
        chunk_len = cs.permutation_chunk_len()
        if cs.perm_columns:
            z0 = evals[(("perm_z", 0), 0)]
            constraints.append(e.mulf(l0, e.subf("1", z0)))
            zl = evals[(("perm_z", nchunks - 1), 0)]
            constraints.append(e.mulf(llast, e.subf(e.mulf(zl, zl), zl)))
            for i in range(1, nchunks):
                zi = evals[(("perm_z", i), 0)]
                zp = evals[(("perm_z", i - 1), u)]
                constraints.append(e.mulf(l0, e.subf(zi, zp)))
            for ci, cstart in enumerate(
                range(0, len(cs.perm_columns), chunk_len)
            ):
                chunk = list(range(cstart, min(cstart + chunk_len,
                                               len(cs.perm_columns))))
                left = evals[(("perm_z", ci), 1)]
                right = evals[(("perm_z", ci), 0)]
                for j in chunk:
                    kind, idx = cs.perm_columns[j]
                    v = get_var(kind, idx, 0)
                    sig = evals[(("sigma", j), 0)]
                    dj = _fmt(pow(BN254_FR_DELTA, j, R))
                    left = e.mulf(
                        left, e.addf(e.addf(v, e.mulf(beta, sig)), gamma)
                    )
                    idterm = e.mulf(e.mulf(beta, dj), x_ch)
                    right = e.mulf(right, e.addf(e.addf(v, idterm), gamma))
                constraints.append(e.mulf(active, e.subf(left, right)))
        for li, lk in enumerate(cs.lookups):
            z = evals[(("lookup_z", li), 0)]
            zn = evals[(("lookup_z", li), 1)]
            ap = evals[(("lookup_ap", li), 0)]
            app = evals[(("lookup_ap", li), -1)]
            sp = evals[(("lookup_sp", li), 0)]

            def comp(exprs):
                acc = None
                for ex in exprs:
                    v = ex.eval(
                        get_var,
                        lambda c: _fmt(c % R),
                        lambda a, b: e.addf(a, b),
                        lambda a, b: e.mulf(a, b),
                        lambda a, c: e.mulf(a, _fmt(c % R)),
                    )
                    acc = v if acc is None else e.addf(e.mulf(acc, theta), v)
                return acc

            a_c = comp(lk.inputs)
            s_c = comp(lk.tables)
            constraints.append(e.mulf(l0, e.subf("1", z)))
            constraints.append(e.mulf(llast, e.subf(e.mulf(z, z), z)))
            lhs = e.mulf(e.mulf(zn, e.addf(ap, beta)), e.addf(sp, gamma))
            rhs = e.mulf(e.mulf(z, e.addf(a_c, beta)), e.addf(s_c, gamma))
            constraints.append(e.mulf(active, e.subf(lhs, rhs)))
            constraints.append(
                e.mulf(e.mulf(active, e.subf(ap, sp)), e.subf(ap, app))
            )
            constraints.append(e.mulf(l0, e.subf(ap, sp)))

        h_num = "0"
        for c in constraints:
            h_num = e.addf(e.mulf(h_num, y_ch), c)
        return h_num

    def _tail_shplonk(self, evals, order, advice, lk_perm, perm_z, lk_z,
                      random_c, h_coms, c_inst, theta, beta, gamma,
                      y_ch, x_ch) -> str:
        """SHPLONK (BDFG20) verification tail — mirrors
        plonk/verifier.py's shplonk branch. One ecMul per DISTINCT
        commitment (vs one per query in GWC) and a single batch-inverted
        modexp for every inversion."""
        vk = self.vk
        cs = vk.cs
        e = self.e
        domain = vk.domain
        n = domain.n
        u = cs.usable_rows(n)
        omega = domain.omega
        nchunks = cs.num_perm_chunks()

        # remaining transcript: y2, v, C_H, u_pt, W
        y2 = self.squeeze()
        v_ch = self.squeeze()
        h_open = self.read_point()
        u_ch = self.squeeze()
        w_com = self.read_point()
        e.line(f"if iszero(eq(calldatasize(), {_fmt(self.cd_off)}))"
               " { revert(0, 0) }")

        # xn, zh
        xn = x_ch
        for _ in range(domain.k):
            xn = e.mulf(xn, xn)
        zh = e.subf(xn, "1")
        e.line(f"if iszero({zh}) {{ revert(0, 0) }}")

        # rotation-set structure (host bookkeeping, matches the prover)
        by_poly: list = []
        seen: dict = {}
        queries = [(lbl, rot, evals[(lbl, rot)]) for lbl, rot in order]
        # h is opened at rot 0 with the (not yet emitted) expected eval
        for label, rot, ev in queries:
            if label not in seen:
                seen[label] = len(by_poly)
                by_poly.append((label, {}))
            by_poly[seen[label]][1][rot] = ev
        sets: dict[tuple, list] = {}
        h_key = ("h",)
        by_poly.append((h_key, {0: None}))  # eval filled in below
        seen[h_key] = len(by_poly) - 1
        for label, rmap in by_poly:
            rkey = tuple(sorted(rmap.keys()))
            sets.setdefault(rkey, []).append((label, rmap))
        set_list = sorted(sets.items(), key=lambda kv: kv[0])

        # symbolic rotation points and all denominators
        all_rots = sorted({r for rkey, _ in set_list for r in rkey})
        pt_expr: dict[int, str] = {}
        for r in all_rots:
            if r >= 0:
                pt_expr[r] = e.mulf(x_ch, _fmt(pow(omega, r, R)))
            else:
                pt_expr[r] = e.mulf(
                    x_ch, _fmt(pow(pow(omega, -r, R), R - 2, R)))

        lag_rows = [0, u] + list(range(u + 1, n))
        dens: list[str] = [zh]
        for i in lag_rows:
            dens.append(e.subf(x_ch, _fmt(pow(omega, i, R))))
        upt: dict[int, str] = {}
        for r in all_rots:
            upt[r] = e.subf(u_ch, pt_expr[r])
            dens.append(upt[r])
        # pairwise denominators for the barycentric r_s(u) terms
        pair_dens: dict[tuple, str] = {}  # (set_idx, i) -> prod expr
        for s_i, (rkey, _polys) in enumerate(set_list):
            if len(rkey) == 1:
                continue
            for i, ri in enumerate(rkey):
                prod = None
                for j, rj in enumerate(rkey):
                    if i == j:
                        continue
                    d = e.subf(pt_expr[ri], pt_expr[rj])
                    prod = d if prod is None else e.mulf(prod, d)
                pair_dens[(s_i, i)] = prod
                dens.append(prod)

        invs = self.batch_inv(dens)
        inv_of = dict(zip(dens, invs))
        zh_inv = invs[0]

        # Lagrange values + gate/permutation/lookup constraint fold
        ninv = _fmt(pow(n, -1, R))

        def lagrange_at(i: int, den_expr: str) -> str:
            wi = _fmt(pow(omega, i, R))
            num = e.mulf(wi, zh)
            return e.mulf(num, e.mulf(ninv, inv_of[den_expr]))

        l0 = lagrange_at(0, dens[1])
        llast = lagrange_at(u, dens[2])
        lblind = "0"
        for k_i, i in enumerate(range(u + 1, n)):
            lblind = e.addf(lblind, lagrange_at(i, dens[3 + k_i]))
        active = e.subf(e.subf("1", llast), lblind)

        h_num = self._emit_constraints(evals, theta, beta, gamma, y_ch,
                                       x_ch, l0, llast, active)
        h_exp = e.mulf(h_num, zh_inv)
        for label, rmap in by_poly:
            if label == h_key:
                rmap[0] = h_exp

        # commitment map
        com_map: dict = {}
        for i in range(cs.num_advice):
            com_map[(CS.ADVICE, i)] = advice[i]
        for i in range(cs.num_fixed):
            fx = vk.fixed_commitments[i]
            com_map[(CS.FIXED, i)] = (
                _fmt(fx[0] if fx else 0), _fmt(fx[1] if fx else 0)
            )
        com_map[("random",)] = random_c
        if self.num_public:
            com_map[(CS.INSTANCE, 0)] = c_inst
        for j in range(len(cs.perm_columns)):
            pc = vk.perm_commitments[j]
            com_map[("sigma", j)] = (_fmt(pc[0]), _fmt(pc[1]))
        for i in range(nchunks):
            com_map[("perm_z", i)] = perm_z[i]
        for li in range(len(cs.lookups)):
            com_map[("lookup_z", li)] = lk_z[li]
            com_map[("lookup_ap", li)] = lk_perm[li][0]
            com_map[("lookup_sp", li)] = lk_perm[li][1]
        # folded quotient commitment sum x^(n i) h_i
        xn_pow = "1"
        h_com = None
        for i, hc in enumerate(h_coms):
            term = self.ec_mul(hc, xn_pow) if i else hc
            h_com = term if h_com is None else self.ec_add(h_com, term)
            xn_pow = e.mulf(xn_pow, xn)
        com_map[h_key] = h_com

        # Z_T(u) over all distinct points
        z_t_u = None
        for r in all_rots:
            z_t_u = upt[r] if z_t_u is None else e.mulf(z_t_u, upt[r])

        # y2 powers per set
        S = len(set_list)
        y2_pows = []
        for s_i in range(S):
            y2_pows.append(_pow_sym(e, y2, S - 1 - s_i))

        # accumulate sum_s y2^pow scale_s (F_s - r_s(u) G1) - Z_T(u) C_H
        # + u W  as one running ec accumulator
        acc_pt = None
        g1_scalar = "0"
        for s_i, (rkey, polys) in enumerate(set_list):
            # scale_s = Z_T(u) / Z_S(u) = Z_T(u) * prod inv(u - pt)
            scale = z_t_u
            for r in rkey:
                scale = e.mulf(scale, inv_of[upt[r]])
            coef_base = e.mulf(y2_pows[s_i], scale)
            npolys = len(polys)
            # z_s_u = prod (u - pt) over the set (for barycentric r_s(u))
            z_s_u = None
            for r in rkey:
                z_s_u = upt[r] if z_s_u is None else e.mulf(z_s_u, upt[r])
            for p_i, (label, rmap) in enumerate(polys):
                vpow = _pow_sym(e, v_ch, npolys - 1 - p_i)
                coef = e.mulf(coef_base, vpow) if vpow != "1" else coef_base
                term = self.ec_mul(com_map[label], coef)
                acc_pt = term if acc_pt is None else self.ec_add(acc_pt, term)
            # r_s(u) = sum_i ev_i * (z_s_u * inv(u - pt_i)) * inv(d_i)
            r_u = "0"
            for i, r in enumerate(rkey):
                ev_acc = None
                for label, rmap in polys:
                    evx = rmap[r]
                    ev_acc = evx if ev_acc is None else \
                        e.addf(e.mulf(ev_acc, v_ch), evx)
                term = e.mulf(z_s_u, inv_of[upt[r]])
                if len(rkey) > 1:
                    term = e.mulf(term, inv_of[pair_dens[(s_i, i)]])
                r_u = e.addf(r_u, e.mulf(ev_acc, term))
            g1_scalar = e.subf(g1_scalar, e.mulf(coef_base, r_u))

        # - Z_T(u) C_H
        term = self.ec_mul(h_open, e.subf("0", z_t_u))
        acc_pt = self.ec_add(acc_pt, term)
        # + g1_scalar * G1
        term = self.ec_mul((_fmt(1), _fmt(2)), g1_scalar)
        acc_pt = self.ec_add(acc_pt, term)
        # + u * W
        term = self.ec_mul(w_com, u_ch)
        acc_pt = self.ec_add(acc_pt, term)

        # pairing: e(acc, G2) * e(-W, sG2) == 1
        g2 = self.srs.g2
        sg2 = self.srs.s_g2
        P = self.PAIR_IN
        pairs = [
            (acc_pt, g2),
            ((w_com[0], e.let(f"sub(Q_MOD, {w_com[1]})")), sg2),
        ]
        for pi, (g1pt, g2pt) in enumerate(pairs):
            base = P + pi * 192
            e.line(f"mstore({_fmt(base)}, {g1pt[0]})")
            e.line(f"mstore({_fmt(base + 32)}, {g1pt[1]})")
            (x0, x1), (y0, y1) = g2pt
            e.line(f"mstore({_fmt(base + 64)}, {_fmt(x1)})")
            e.line(f"mstore({_fmt(base + 96)}, {_fmt(x0)})")
            e.line(f"mstore({_fmt(base + 128)}, {_fmt(y1)})")
            e.line(f"mstore({_fmt(base + 160)}, {_fmt(y0)})")
        e.line(
            f"if iszero(staticcall(gas(), 8, {_fmt(P)}, 384, {_fmt(P)}, 32))"
            " { revert(0, 0) }"
        )
        e.line(f"if iszero(mload({_fmt(P)})) {{ revert(0, 0) }}")
        e.line("return(0, 0)")

        body = "\n            ".join(self.e.lines)
        return YUL_TEMPLATE.format(
            r_mod=_fmt(R), q_mod=_fmt(Q), body=body
        )

    # --- the full procedure ----------------------------------------------
    def generate(self) -> str:
        vk = self.vk
        cs = vk.cs
        e = self.e
        domain = vk.domain
        n = domain.n
        usable = cs.usable_rows(n)
        u = usable
        omega = domain.omega

        # vk digest (verifier.py: vk.hash_into)
        self.absorb_words([_fmt(vk.transcript_repr % R)])

        # public inputs: leading calldata words. The verifier computes the
        # instance commitment ITSELF (sparse Lagrange MSM over the public
        # values via ecMul/ecAdd) and the multiopen pins the proof's
        # claimed instance evals to it — on-chain message binding
        # (P256Account.sol:77 TODO; the reference verifies zero-instance
        # proofs only).
        c_inst = None
        if self.num_public:
            assert cs.num_instance == 1, "codegen supports one instance col"
            from ..plonk.verifier import _g_lag_prefix

            g_lag = _g_lag_prefix(self.srs, self.num_public)
            for i in range(self.num_public):
                p = e.let(f"calldataload({_fmt(self.cd_off)})", f"pub{i}")
                self.cd_off += 32
                e.line(f"if iszero(lt({p}, R_MOD)) {{ revert(0, 0) }}")
                self.absorb_words([p])
                gx, gy = g_lag[i]
                term = self.ec_mul((_fmt(gx), _fmt(gy)), p)
                c_inst = term if c_inst is None else self.ec_add(c_inst, term)

        advice = [self.read_point() for _ in range(cs.num_advice)]
        theta = self.squeeze()
        lk_perm = [(self.read_point(), self.read_point()) for _ in cs.lookups]
        beta = self.squeeze()
        gamma = self.squeeze()
        nchunks = cs.num_perm_chunks()
        perm_z = [self.read_point() for _ in range(nchunks)]
        lk_z = [self.read_point() for _ in cs.lookups]
        random_c = self.read_point()
        y_ch = self.squeeze()
        h_coms = [self.read_point() for _ in range(cs.degree() - 1)]
        x_ch = self.squeeze()

        # evals (same order as the prover/verifier)
        sq = cs.sorted_queries()
        evals: dict = {}
        order: list[tuple] = []

        def rd(label, rot):
            s = self.read_scalar()
            evals[(label, rot)] = s
            order.append((label, rot))

        for idx, rot in sq[CS.ADVICE]:
            rd((CS.ADVICE, idx), rot)
        for idx, rot in sq[CS.FIXED]:
            rd((CS.FIXED, idx), rot)
        for idx, rot in sq[CS.INSTANCE]:
            rd((CS.INSTANCE, idx), rot)
        rd(("random",), 0)
        for j in range(len(cs.perm_columns)):
            rd(("sigma", j), 0)
        for i in range(nchunks):
            rd(("perm_z", i), 0)
            rd(("perm_z", i), 1)
        for i in range(nchunks - 1):
            rd(("perm_z", i), u)
        for li in range(len(cs.lookups)):
            rd(("lookup_z", li), 0)
            rd(("lookup_z", li), 1)
            rd(("lookup_ap", li), 0)
            rd(("lookup_ap", li), -1)
            rd(("lookup_sp", li), 0)

        if self.scheme == "shplonk":
            return self._tail_shplonk(
                evals, order, advice, lk_perm, perm_z, lk_z, random_c,
                h_coms, c_inst, theta, beta, gamma, y_ch, x_ch)

        # --- expected quotient eval ---
        xn = x_ch
        for _ in range(domain.k):
            xn = e.mulf(xn, xn)
        zh = e.subf(xn, "1")
        e.line(f"if iszero({zh}) {{ revert(0, 0) }}")

        ninv = _fmt(pow(n, -1, R))

        def lagrange_at(i: int) -> str:
            wi = _fmt(pow(omega, i, R))
            num = e.mulf(wi, zh)
            den = e.mulf(ninv, self.finv(e.subf(x_ch, wi)))
            return e.mulf(num, den)

        l0 = lagrange_at(0)
        llast = lagrange_at(u)
        lblind = "0"
        for i in range(u + 1, n):
            lblind = e.addf(lblind, lagrange_at(i))
        active = e.subf(e.subf("1", llast), lblind)

        h_num = self._emit_constraints(evals, theta, beta, gamma, y_ch,
                                       x_ch, l0, llast, active)
        h_exp = e.mulf(h_num, self.finv(zh))

        # h commitment fold: sum x^(n*i) h_i
        xn_pow = "1"
        h_com = None
        for i, hc in enumerate(h_coms):
            term = self.ec_mul(hc, xn_pow) if i else hc
            h_com = term if h_com is None else self.ec_add(h_com, term)
            xn_pow = e.mulf(xn_pow, xn)

        # --- GWC check (verifier._check_gwc parity) ---
        com_map: dict = {}
        for i in range(cs.num_advice):
            com_map[(CS.ADVICE, i)] = advice[i]
        for i in range(cs.num_fixed):
            fx = vk.fixed_commitments[i]
            com_map[(CS.FIXED, i)] = (
                _fmt(fx[0] if fx else 0), _fmt(fx[1] if fx else 0)
            )
        com_map[("random",)] = random_c
        if self.num_public:
            com_map[(CS.INSTANCE, 0)] = c_inst
        for j in range(len(cs.perm_columns)):
            pc = vk.perm_commitments[j]
            com_map[("sigma", j)] = (_fmt(pc[0]), _fmt(pc[1]))
        for i in range(nchunks):
            com_map[("perm_z", i)] = perm_z[i]
        for li in range(len(cs.lookups)):
            com_map[("lookup_z", li)] = lk_z[li]
            com_map[("lookup_ap", li)] = lk_perm[li][0]
            com_map[("lookup_sp", li)] = lk_perm[li][1]

        queries = [(lbl, rot, evals[(lbl, rot)]) for lbl, rot in order]
        queries.append((("h",), 0, h_exp))
        com_map[("h",)] = h_com

        v_ch = self.squeeze()
        groups: dict[int, list] = {}
        grp_order: list[int] = []
        for label, rot, ev in queries:
            if rot not in groups:
                groups[rot] = []
                grp_order.append(rot)
            groups[rot].append((label, ev))
        w_coms = [self.read_point() for _ in grp_order]
        u_ch = self.squeeze()

        def rot_point(rot: int) -> str:
            if rot >= 0:
                return e.mulf(x_ch, _fmt(pow(omega, rot, R)))
            return e.mulf(x_ch, _fmt(pow(pow(omega, -rot, R), R - 2, R)))

        lhs_acc = None
        rhs_acc = None
        g1 = ( _fmt(1), _fmt(2) )
        upow = "1"
        for j, rot in enumerate(grp_order):
            polys = groups[rot]
            m = len(polys)
            r_comb = "0"
            grp_com = None
            for i, (label, ev) in enumerate(polys):
                coef = e.mulf(upow, _pow_sym(e, v_ch, m - 1 - i))
                term = self.ec_mul(com_map[label], coef)
                grp_com = term if grp_com is None else self.ec_add(grp_com, term)
                r_comb = e.addf(e.mulf(r_comb, v_ch), ev)
            z = rot_point(rot)
            zw = self.ec_mul(w_coms[j], e.mulf(upow, z))
            rg = self.ec_mul(g1, e.mulf(upow, r_comb))
            rg_neg = (rg[0], e.let(f"sub(Q_MOD, {rg[1]})"))
            rhs_j = self.ec_add(self.ec_add(grp_com, zw), rg_neg)
            rhs_acc = rhs_j if rhs_acc is None else self.ec_add(rhs_acc, rhs_j)
            lw = self.ec_mul(w_coms[j], upow)
            lhs_acc = lw if lhs_acc is None else self.ec_add(lhs_acc, lw)
            upow = e.mulf(upow, u_ch)

        # trailing calldata must be fully consumed
        e.line(f"if iszero(eq(calldatasize(), {_fmt(self.cd_off)}))"
               " { revert(0, 0) }")

        # pairing: e(lhs, tauG2) * e(-rhs, G2) == 1
        g2 = self.srs.g2
        sg2 = self.srs.s_g2
        P = self.PAIR_IN
        pairs = [
            (lhs_acc, sg2),
            ((rhs_acc[0], e.let(f"sub(Q_MOD, {rhs_acc[1]})")), g2),
        ]
        for pi, (g1pt, g2pt) in enumerate(pairs):
            base = P + pi * 192
            e.line(f"mstore({_fmt(base)}, {g1pt[0]})")
            e.line(f"mstore({_fmt(base + 32)}, {g1pt[1]})")
            (x0, x1), (y0, y1) = g2pt
            e.line(f"mstore({_fmt(base + 64)}, {_fmt(x1)})")
            e.line(f"mstore({_fmt(base + 96)}, {_fmt(x0)})")
            e.line(f"mstore({_fmt(base + 128)}, {_fmt(y1)})")
            e.line(f"mstore({_fmt(base + 160)}, {_fmt(y0)})")
        e.line(
            f"if iszero(staticcall(gas(), 8, {_fmt(P)}, 384, {_fmt(P)}, 32))"
            " { revert(0, 0) }"
        )
        e.line(f"if iszero(mload({_fmt(P)})) {{ revert(0, 0) }}")
        e.line("return(0, 0)")

        body = "\n            ".join(self.e.lines)
        return YUL_TEMPLATE.format(
            r_mod=_fmt(R), q_mod=_fmt(Q), body=body
        )


def _pow_sym(e: Emitter, base: str, exp: int) -> str:
    if exp == 0:
        return "1"
    acc = base
    for _ in range(exp - 1):
        acc = e.mulf(acc, base)
    return acc


YUL_TEMPLATE = """object "plonk_verifier" {{
    code {{
        // constructor: copy runtime
        datacopy(0, dataoffset("Runtime"), datasize("Runtime"))
        return(0, datasize("Runtime"))
    }}
    object "Runtime" {{
        code {{
            let R_MOD := {r_mod}
            let Q_MOD := {q_mod}
            {body}
        }}
    }}
}}
"""

SOL_TEMPLATE = """// SPDX-License-Identifier: MIT
// Auto-generated GWC/Keccak PLONK verifier (webauthn-halo2-tpu codegen).
// The raw proof bytes are the calldata of `verify`'s inner call; success
// returns true, any failure reverts the inner call and returns false.
pragma solidity ^0.8.17;

contract Verifier {{
    bytes public constant RUNTIME_NOTE =
        "inline-assembly port of the generated Yul; see .yul artifact";

    function verify(bytes memory proof) public view returns (bool) {{
        address self = address(this);
        // delegate the check to the raw-calldata entrypoint below
        (bool ok, ) = self.staticcall(proof);
        return ok;
    }}

    fallback() external {{
        assembly {{
{asm_body}
        }}
    }}
}}
"""


def generate_verifier(vk: VerifyingKey, srs, num_public: int = 0,
                      scheme: str = "gwc") -> tuple[str, str]:
    """Returns (yul_source, solidity_source). With num_public > 0, the
    verifier expects calldata = num_public 32-byte public-input words
    followed by the proof, and binds them on chain. scheme="shplonk"
    verifies SHPLONK+Keccak proofs with ~half the ecMul precompile calls
    of the GWC form (one scalar per distinct commitment)."""
    gen = VerifierCodegen(vk, srs, num_public, scheme)
    yul = gen.generate()
    asm_body = "\n".join(
        "            " + ln
        for ln in (
            [f"let R_MOD := {_fmt(R)}", f"let Q_MOD := {_fmt(Q)}"]
            + gen.e.lines
        )
    )
    sol = SOL_TEMPLATE.format(asm_body=asm_body)
    return yul, sol
