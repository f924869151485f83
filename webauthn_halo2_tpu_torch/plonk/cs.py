"""PLONKish constraint system: columns, gate expressions, lookups, copies.

The structural core the reference gets from `halo2_proofs::plonk`
(ConstraintSystem / Expression — SURVEY §2.2). Expressions form a small AST
that evaluates in two worlds with one tree walk:
  * device: (8, m) Montgomery word tensors (quotient construction) via a
    column getter;
  * host: Python ints (verifier's gate evaluation at the challenge point x).

Selectors are plain fixed columns (no selector compression pass); rotations
are row-relative with wraparound, exactly like halo2's Rotation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.constants import BN254_FR
from ..fields.limbs import FR_SPEC
from ..ops import modops as M

R = BN254_FR

FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"


# ---------------------------------------------------------------------------
# Expression AST
# ---------------------------------------------------------------------------

class Expr:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Scaled(_wrap(other), R - 1))

    def __rsub__(self, other):
        return Sum(_wrap(other), Scaled(self, R - 1))

    def __mul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other % R)
        return Prod(self, _wrap(other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Scaled(self, R - 1)

    def degree(self) -> int:
        raise NotImplementedError

    def queries(self) -> set:
        """Set of (kind, index, rotation) column queries in this expression."""
        raise NotImplementedError

    def eval(self, var_fn, const_fn, add_fn, mul_fn, scale_fn):
        """Generic fold. var_fn(kind, idx, rot); const_fn(int);
        add/mul(a, b); scale_fn(a, int)."""
        raise NotImplementedError


def _wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Const(x % R)
    raise TypeError(f"cannot use {type(x)} in an expression")


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def degree(self):
        return 0

    def queries(self):
        return set()

    def eval(self, var_fn, const_fn, add_fn, mul_fn, scale_fn):
        return const_fn(self.value)


@dataclass(frozen=True)
class Var(Expr):
    kind: str
    index: int
    rotation: int = 0

    def degree(self):
        return 1

    def queries(self):
        return {(self.kind, self.index, self.rotation)}

    def eval(self, var_fn, const_fn, add_fn, mul_fn, scale_fn):
        return var_fn(self.kind, self.index, self.rotation)


@dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def queries(self):
        return self.a.queries() | self.b.queries()

    def eval(self, var_fn, const_fn, add_fn, mul_fn, scale_fn):
        return add_fn(
            self.a.eval(var_fn, const_fn, add_fn, mul_fn, scale_fn),
            self.b.eval(var_fn, const_fn, add_fn, mul_fn, scale_fn),
        )


@dataclass(frozen=True)
class Prod(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return self.a.degree() + self.b.degree()

    def queries(self):
        return self.a.queries() | self.b.queries()

    def eval(self, var_fn, const_fn, add_fn, mul_fn, scale_fn):
        return mul_fn(
            self.a.eval(var_fn, const_fn, add_fn, mul_fn, scale_fn),
            self.b.eval(var_fn, const_fn, add_fn, mul_fn, scale_fn),
        )


@dataclass(frozen=True)
class Scaled(Expr):
    a: Expr
    c: int

    def degree(self):
        return self.a.degree()

    def queries(self):
        return self.a.queries()

    def eval(self, var_fn, const_fn, add_fn, mul_fn, scale_fn):
        return scale_fn(self.a.eval(var_fn, const_fn, add_fn, mul_fn, scale_fn), self.c)


def advice(index: int, rotation: int = 0) -> Var:
    return Var(ADVICE, index, rotation)


def fixed(index: int, rotation: int = 0) -> Var:
    return Var(FIXED, index, rotation)


def instance(index: int, rotation: int = 0) -> Var:
    return Var(INSTANCE, index, rotation)


# --- evaluation adapters ---

def eval_host(expr: Expr, get_var) -> int:
    """Evaluate with Python ints; get_var(kind, idx, rot) -> int."""
    return expr.eval(
        get_var,
        lambda c: c,
        lambda a, b: (a + b) % R,
        lambda a, b: a * b % R,
        lambda a, c: a * c % R,
    )


def eval_device(expr: Expr, get_var, device):
    """Evaluate over (8, m) Montgomery word tensors on `device`;
    get_var -> tensor. Constants are (8, 1) and broadcast."""
    spec = FR_SPEC

    def const_fn(c):
        return M.const(spec, c, device)

    return expr.eval(
        get_var,
        const_fn,
        lambda a, b: M.add(spec, a, b),
        lambda a, b: M.montmul(spec, a, b),
        lambda a, c: M.montmul(spec, a, const_fn(c)),
    )


# ---------------------------------------------------------------------------
# Constraint system
# ---------------------------------------------------------------------------

@dataclass
class Lookup:
    name: str
    inputs: list  # list[Expr], compressed with theta
    tables: list  # list[Expr]


@dataclass
class ConstraintSystem:
    num_fixed: int = 0
    num_advice: int = 0
    num_instance: int = 0
    gates: list = field(default_factory=list)  # (name, Expr)
    lookups: list = field(default_factory=list)  # Lookup
    perm_columns: list = field(default_factory=list)  # [(kind, index)]

    def gate(self, name: str, poly: Expr) -> None:
        self.gates.append((name, poly))

    def lookup(self, name: str, inputs: list, tables: list) -> None:
        assert len(inputs) == len(tables)
        self.lookups.append(Lookup(name, inputs, tables))

    def enable_permutation(self, kind: str, index: int) -> None:
        if (kind, index) not in self.perm_columns:
            self.perm_columns.append((kind, index))

    # --- derived quantities ---
    def gate_degree(self) -> int:
        return max((g.degree() for _, g in self.gates), default=1)

    def degree(self) -> int:
        """Max constraint degree across gates and built-in arguments."""
        d = self.gate_degree()
        # lookup product rule: active(1) * z(1) * (A'+beta)(1) * (S'+gamma)(1)
        # and active * (z(w X)(A'+b)(S'+g) - z(A+b)(S+g)): 3 + max input deg
        for lk in self.lookups:
            in_deg = max((e.degree() for e in lk.inputs), default=1)
            t_deg = max((e.degree() for e in lk.tables), default=1)
            d = max(d, 2 + in_deg + t_deg, 4)
        # permutation: chunked so that 2 + chunk_len <= degree; with
        # chunk_len >= 1 the floor is 3 (plus active-row factor -> 4).
        # Only applies when a permutation argument exists — a gates-only
        # circuit keeps its true degree (avoids all-zero quotient pieces)
        if self.perm_columns:
            d = max(d, 4)
        return max(d, 2)

    def permutation_chunk_len(self) -> int:
        return self.degree() - 2

    def num_perm_chunks(self) -> int:
        cl = self.permutation_chunk_len()
        return -(-len(self.perm_columns) // cl) if self.perm_columns else 0

    def blinding_factors(self) -> int:
        """Number of random tail rows on advice columns (zk)."""
        max_adv_rot = 1
        counts: dict[int, set] = {}
        for q in self.all_queries():
            if q[0] == ADVICE:
                counts.setdefault(q[1], set()).add(q[2])
        for rots in counts.values():
            max_adv_rot = max(max_adv_rot, len(rots))
        # +1: the permutation argument queries z at (w^u X) ("last" rotation)
        # +1: quotient division safety row (mirrors halo2's accounting)
        return max(3, max_adv_rot) + 2

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)

    def all_queries(self) -> set:
        qs: set = set()
        for _, g in self.gates:
            qs |= g.queries()
        for lk in self.lookups:
            for e in lk.inputs + lk.tables:
                qs |= e.queries()
        # base queries so every column is openable
        for i in range(self.num_advice):
            qs.add((ADVICE, i, 0))
        for i in range(self.num_fixed):
            qs.add((FIXED, i, 0))
        for i in range(self.num_instance):
            qs.add((INSTANCE, i, 0))
        return qs

    def sorted_queries(self) -> dict:
        """Deterministic query lists per kind: [(index, rotation), ...]."""
        out = {FIXED: [], ADVICE: [], INSTANCE: []}
        for kind, idx, rot in sorted(self.all_queries()):
            out[kind].append((idx, rot))
        return out
