"""The PLONK verifier (host-side): verify_proof with SingleStrategy parity.

A copy of the JAX package's plonk/verifier.py: it mirrors every prover
phase over Python ints and ends in one pairing check; the host MSM and the
pairing run in the native library (csrc/host/pairing.cpp). Only
`_g_lag_prefix` touches tensors (the port's SRS, through ops/ec).
"""
from __future__ import annotations

from ..fields.constants import BN254_FR, BN254_FR_DELTA
from ..fields.ref_curve import BN254_G1_CURVE
from ..fields.ref_field import inv_mod
from ..fields import pairing_native
from ..fields.pairing import pairing_check
from . import cs as CS
from .keygen import VerifyingKey
from .prover import _interp
from .transcript import Blake2bRead

R = BN254_FR
G = BN254_G1_CURVE


def _host_msm(pairs):
    """sum s*P over host affine int points (None skipped), in the native
    library (csrc/host/pairing.cpp; a failed build raises)."""
    return pairing_native.g1_msm(pairs)


def _host_msm_py(pairs):
    """_host_msm in pure Python: the oracle the native MSM is held against."""
    acc = None
    for pt, sc in pairs:
        acc = G.add(acc, G.mul(sc % R, pt))
    return acc


LAST_DEBUG: dict = {}


def verify_proof(vk: VerifyingKey, srs, proof: bytes, instances: list,
                 scheme: str = "shplonk", transcript=None) -> bool:
    try:
        return _verify(vk, srs, proof, instances, scheme, transcript)
    except (ValueError, ZeroDivisionError):
        return False


def _verify(vk: VerifyingKey, srs, proof: bytes, instances: list,
            scheme: str = "shplonk", transcript=None) -> bool:
    cs = vk.cs
    domain = vk.domain
    n = domain.n
    ratio = domain.ext_n // n
    usable = cs.usable_rows(n)
    u = usable  # boundary row (see prover.py)
    omega = domain.omega
    t = transcript if transcript is not None else Blake2bRead(proof)
    vk.hash_into(t)

    inst_vals = []
    for col in instances:
        vals = [v % R for v in col]
        for v in vals:
            t.common_scalar(v)
        inst_vals.append(vals)

    advice_coms = [t.read_point() for _ in range(cs.num_advice)]
    theta = t.squeeze_challenge()
    lk_permuted = [(t.read_point(), t.read_point()) for _ in cs.lookups]
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    nchunks = cs.num_perm_chunks()
    perm_z_coms = [t.read_point() for _ in range(nchunks)]
    lk_z_coms = [t.read_point() for _ in cs.lookups]
    random_com = t.read_point()
    y = t.squeeze_challenge()
    h_coms = [t.read_point() for _ in range(cs.degree() - 1)]
    x = t.squeeze_challenge()

    # --- read evaluations (must mirror prover order exactly) ---
    sq = cs.sorted_queries()
    evals: dict = {}
    queries = []  # ordered (label, rot, eval); label -> commitment via com_of

    def rd(label, rot):
        ev = t.read_scalar()
        evals[(label, rot)] = ev
        queries.append((label, rot, ev))
        return ev

    for idx, rot in sq[CS.ADVICE]:
        rd((CS.ADVICE, idx), rot)
    for idx, rot in sq[CS.FIXED]:
        rd((CS.FIXED, idx), rot)
    for idx, rot in sq[CS.INSTANCE]:
        rd((CS.INSTANCE, idx), rot)
    random_eval = rd(("random",), 0)
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

    # --- expected quotient evaluation at x ---
    xn = pow(x, n, R)
    zh = (xn - 1) % R
    if zh == 0:
        return False

    def lagrange_at(i: int) -> int:
        wi = pow(omega, i, R)
        return wi * zh % R * inv_mod(n * ((x - wi) % R) % R, R) % R

    l0 = lagrange_at(0)
    llast = lagrange_at(u)
    lblind = 0
    for i in range(u + 1, n):
        lblind = (lblind + lagrange_at(i)) % R
    active = (1 - llast - lblind) % R

    def get_var(kind, idx, rot):
        if kind == CS.INSTANCE:
            # instance columns are public: barycentric-evaluate at x*w^rot
            col = inst_vals[idx] if idx < len(inst_vals) else []
            pt = x * pow(omega, rot, R) % R if rot >= 0 else (
                x * inv_mod(pow(omega, -rot, R), R) % R
            )
            ptn = (pow(pt, n, R) - 1) % R
            acc = 0
            for i, v in enumerate(col):
                wi = pow(omega, i, R)
                acc = (acc + v * wi % R * ptn % R *
                       inv_mod(n * ((pt - wi) % R) % R, R)) % R
            return acc
        return evals[((kind, idx), rot)]

    constraints = []
    for _, g in cs.gates:
        constraints.append(CS.eval_host(g, get_var))

    chunk_len = cs.permutation_chunk_len()
    if cs.perm_columns:
        z0 = evals[(("perm_z", 0), 0)]
        constraints.append(l0 * (1 - z0) % R)
        zl = evals[(("perm_z", nchunks - 1), 0)]
        constraints.append(llast * (zl * zl - zl) % R)
        for i in range(1, nchunks):
            zi = evals[(("perm_z", i), 0)]
            zprev_u = evals[(("perm_z", i - 1), u)]
            constraints.append(l0 * (zi - zprev_u) % R)
        for ci, cstart in enumerate(range(0, len(cs.perm_columns), chunk_len)):
            chunk = list(
                range(cstart, min(cstart + chunk_len, len(cs.perm_columns)))
            )
            left = evals[(("perm_z", ci), 1)]
            right = evals[(("perm_z", ci), 0)]
            for j in chunk:
                kind, idx = cs.perm_columns[j]
                v = get_var(kind, idx, 0)
                sig = evals[(("sigma", j), 0)]
                dj = pow(BN254_FR_DELTA, j, R)
                left = left * ((v + beta * sig + gamma) % R) % R
                right = right * ((v + beta * dj % R * x + gamma) % R) % R
            constraints.append(active * (left - right) % R)

    for li, lk in enumerate(cs.lookups):
        z = evals[(("lookup_z", li), 0)]
        zn = evals[(("lookup_z", li), 1)]
        ap = evals[(("lookup_ap", li), 0)]
        ap_prev = evals[(("lookup_ap", li), -1)]
        sp = evals[(("lookup_sp", li), 0)]
        a_comp = _compress_host(lk.inputs, get_var, theta)
        s_comp = _compress_host(lk.tables, get_var, theta)
        constraints.append(l0 * (1 - z) % R)
        constraints.append(llast * (z * z - z) % R)
        lhs = zn * ((ap + beta) % R) % R * ((sp + gamma) % R) % R
        rhs = z * ((a_comp + beta) % R) % R * ((s_comp + gamma) % R) % R
        constraints.append(active * (lhs - rhs) % R)
        constraints.append(active * ((ap - sp) % R) % R * ((ap - ap_prev) % R) % R)
        constraints.append(l0 * ((ap - sp) % R) % R)

    h_expected = 0
    for c in constraints:
        h_expected = (h_expected * y + c) % R
    h_expected = h_expected * inv_mod(zh, R) % R
    LAST_DEBUG.clear()
    LAST_DEBUG.update(theta=theta, beta=beta, gamma=gamma, y=y, x=x,
                      h_expected=h_expected, constraints=list(constraints))

    # --- SHPLONK check ---
    # combined h commitment: sum x^{n i} h_i
    com_map = {}
    for i in range(cs.num_advice):
        com_map[(CS.ADVICE, i)] = advice_coms[i]
    for i in range(cs.num_fixed):
        com_map[(CS.FIXED, i)] = vk.fixed_commitments[i]
    com_map[("random",)] = random_com
    for j in range(len(cs.perm_columns)):
        com_map[("sigma", j)] = vk.perm_commitments[j]
    for i in range(nchunks):
        com_map[("perm_z", i)] = perm_z_coms[i]
    for li in range(len(cs.lookups)):
        com_map[("lookup_z", li)] = lk_z_coms[li]
        com_map[("lookup_ap", li)] = lk_permuted[li][0]
        com_map[("lookup_sp", li)] = lk_permuted[li][1]
    h_combined = _host_msm(
        [(hc, pow(xn, i, R)) for i, hc in enumerate(h_coms)])
    com_map[("h",)] = h_combined

    # instance-column commitments: computed BY THE VERIFIER from the
    # public values (sparse Lagrange commit — only the supplied rows are
    # nonzero, so this is len(col) point muls, not 2^k). The multiopen
    # then pins the prover's claimed instance evals to this commitment,
    # which binds the proof to the public inputs. This is the plumbing
    # the reference left TODO (P256Account.sol:77 — binding the userOp
    # hash as a public input).
    if cs.num_instance:
        g_lag_host = _g_lag_prefix(
            srs, max((len(c) for c in inst_vals), default=0))
        for idx in range(cs.num_instance):
            col = inst_vals[idx] if idx < len(inst_vals) else []
            com = _host_msm(
                [(g_lag_host[i], v) for i, v in enumerate(col) if v])
            com_map[(CS.INSTANCE, idx)] = com

    queries.append((("h",), 0, h_expected))

    def rot_point(rot: int) -> int:
        if rot >= 0:
            return x * pow(omega, rot, R) % R
        return x * inv_mod(pow(omega, -rot, R), R) % R

    if scheme == "gwc":
        return _check_gwc(t, queries, com_map, rot_point, srs)
    if scheme != "shplonk":
        raise ValueError(f"unknown multiopen scheme {scheme!r}")


    # group by rotation set (same ordering rules as the prover)
    by_poly = []
    seen = {}
    for label, rot, ev in queries:
        if label not in seen:
            seen[label] = len(by_poly)
            by_poly.append((label, {}))
        by_poly[seen[label]][1][rot] = ev
    sets: dict[tuple, list] = {}
    for label, rmap in by_poly:
        rkey = tuple(sorted(rmap.keys()))
        sets.setdefault(rkey, []).append((label, rmap))
    set_list = sorted(sets.items(), key=lambda kv: kv[0])

    y_ch = t.squeeze_challenge()
    v_ch = t.squeeze_challenge()
    h_com = t.read_point()
    u_ch = t.squeeze_challenge()
    w_com = t.read_point()
    t.assert_consumed()

    all_pts = sorted({rot_point(r) for rkey, _ in set_list for r in rkey})
    z_t_u = 1
    for p_ in all_pts:
        z_t_u = z_t_u * (u_ch - p_) % R

    # L_com = sum_s y^pow scale_s (C_{F_s} - [r_s(u)] G) - Z_T(u) C_H
    acc_pts = []  # (point, scalar) pairs for one host MSM
    g1_scalar = 0
    y_pows = []
    S = len(set_list)
    for s_i, (rkey, polys) in enumerate(set_list):
        y_pows.append(pow(y_ch, S - 1 - s_i, R))
    for s_i, (rkey, polys) in enumerate(set_list):
        pts = [rot_point(r) for r in rkey]
        z_s_u = 1
        for p_ in pts:
            z_s_u = z_s_u * (u_ch - p_) % R
        scale = z_t_u * inv_mod(z_s_u, R) % R
        # within-set combination with v (same Horner order as prover)
        npolys = len(polys)
        for p_i, (label, rmap) in enumerate(polys):
            vpow = pow(v_ch, npolys - 1 - p_i, R)
            acc_pts.append((com_map[label], y_pows[s_i] * scale % R * vpow % R))
        evs = []
        for r in rkey:
            acc = 0
            for label, rmap in polys:
                acc = (acc * v_ch + rmap[r]) % R
            evs.append(acc)
        r_poly = _interp(pts, evs)
        r_u = 0
        for c in reversed(r_poly):
            r_u = (r_u * u_ch + c) % R
        g1_scalar = (g1_scalar - y_pows[s_i] * scale % R * r_u) % R
    acc_pts.append((h_com, (-z_t_u) % R))
    acc_pts.append((G.g, g1_scalar))
    # + u * W for the pairing rearrangement
    acc_pts.append((w_com, u_ch))

    lcom_u_w = _host_msm(acc_pts)

    return pairing_check(
        [(lcom_u_w, srs.g2), (G.neg(w_com), srs.s_g2)]
    )


_G_LAG_CACHE: dict = {}


def _g_lag_prefix(srs, m: int) -> list:
    """First m Lagrange-basis SRS points as host affine ints (cached).

    Keyed by stable SRS identity (seed, k) rather than id(srs): an id can
    be reused after garbage collection, which would silently serve points
    from a different SRS."""
    key = (srs.tau_seed, srs.k, m)
    if key not in _G_LAG_CACHE:
        from ..ops import ec as E

        pts = E.JPoint(srs.g_lag.x[:, :m], srs.g_lag.y[:, :m],
                       srs.g_lag.z[:, :m])
        _G_LAG_CACHE[key] = E.to_affine_ints(E.BN254_CURVE, pts)
    return _G_LAG_CACHE[key]


def _compress_host(exprs, get_var, theta: int) -> int:
    acc = 0
    first = True
    for e in exprs:
        v = CS.eval_host(e, get_var)
        acc = v if first else (acc * theta + v) % R
        first = False
    return acc


def _check_gwc(t, queries, com_map, rot_point, srs) -> bool:
    """GWC19 verification: fold per-point witnesses with u, one 2-pairing."""
    v = t.squeeze_challenge()
    groups: dict[int, list] = {}
    order: list[int] = []
    for label, rot, ev in queries:
        if rot not in groups:
            groups[rot] = []
            order.append(rot)
        groups[rot].append((label, ev))
    w_coms = [t.read_point() for _ in order]
    u = t.squeeze_challenge()
    t.assert_consumed()

    # e(sum u^j W_j, tau G2) == e(sum u^j (z_j W_j + F_j - ev_j G), G2)
    lhs_pts = []  # (point, scalar)
    rhs_pts = []
    upow = 1
    for j, rot in enumerate(order):
        polys = groups[rot]
        r_comb = 0
        vpow = 1
        # Horner order: F = sum v^(m-1-i) C_i; replicate with powers
        m = len(polys)
        for i, (label, ev) in enumerate(polys):
            coef = pow(v, m - 1 - i, R)
            rhs_pts.append((com_map[label], upow * coef % R))
            r_comb = (r_comb * v + ev) % R
        z = rot_point(rot)
        rhs_pts.append((w_coms[j], upow * z % R))
        rhs_pts.append((G.g, (-upow * r_comb) % R))
        lhs_pts.append((w_coms[j], upow))
        upow = upow * u % R

    lhs = _host_msm(lhs_pts)
    rhs = _host_msm(rhs_pts)
    return pairing_check([(lhs, srs.s_g2), (G.neg(rhs), srs.g2)])
