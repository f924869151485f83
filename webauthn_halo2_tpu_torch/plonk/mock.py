"""MockProver: direct constraint evaluation without commitments.

The port of the JAX package's plonk/mock.py (halo2's MockProver, SURVEY
§4.1): every gate on every row, on the device, through the same
expression walk the quotient uses; lookups as tuple inclusion and copy
constraints by value, on the host. No MSM or NTT work, so it is the
quick soundness check while building circuits. The findings are the
JAX package's strings in the JAX package's order.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..device import resolve
from ..fields.constants import BN254_FR
from ..fields.limbs import FR_SPEC
from ..ops import modops as M
from . import cs as CS
from .keygen import encode_column

R = BN254_FR


def mock_prove(
    cs: CS.ConstraintSystem,
    k: int,
    fixed_cols: list,
    advice_cols: list,
    instance_cols: list | None = None,
    copies: list | None = None,
    max_failures: int = 10,
    device=None,
) -> list[str]:
    """Returns [] when satisfied, else human-readable failure strings.
    The gates run on `device` (None: the card)."""
    dev = resolve(device)
    n = 1 << k
    usable = cs.usable_rows(n)
    failures: list[str] = []

    def pad(col):
        return [v % R for v in col] + [0] * (n - len(col))

    fixed = [pad(c) for c in fixed_cols]
    advice = [pad(c) for c in advice_cols]
    instance = [pad(c) for c in (instance_cols or [])]

    on_dev = {
        CS.FIXED: [encode_column(c, dev) for c in fixed],
        CS.ADVICE: [encode_column(c, dev) for c in advice],
        CS.INSTANCE: [encode_column(c, dev) for c in instance],
    }

    def getter(kind, idx, rot):
        src = on_dev[kind][idx]
        return torch.roll(src, -rot, dims=-1) if rot else src

    for name, g in cs.gates:
        ev = CS.eval_device(g, getter, dev)
        bad = torch.nonzero(~M.is_zero(FR_SPEC, ev)).flatten().tolist()
        for row in bad[:max_failures]:
            failures.append(f"gate '{name}' not satisfied at row {row}")
        if len(bad) > max_failures:
            failures.append(f"gate '{name}': ... {len(bad)} rows total")

    host = {CS.FIXED: fixed, CS.ADVICE: advice, CS.INSTANCE: instance}

    def host_getter_at(row):
        def f(kind, idx, rot):
            return host[kind][idx][(row + rot) % n]

        return f

    for lk in cs.lookups:
        # fast path: bare columns at rotation 0 (the range and pair tables)
        simple = all(
            isinstance(e, CS.Var) and e.rotation == 0
            for e in lk.inputs + lk.tables
        )
        if simple:
            cols_in = [host[e.kind][e.index][:usable] for e in lk.inputs]
            cols_tab = [host[e.kind][e.index][:usable] for e in lk.tables]
            table = set(zip(*cols_tab))
            for row, tup in enumerate(zip(*cols_in)):
                if tup not in table:
                    failures.append(
                        f"lookup '{lk.name}': row {row} input {tup} not in table"
                    )
                    if len(failures) >= max_failures:
                        break
            continue
        table = Counter()
        inputs = []
        for row in range(usable):
            gv = host_getter_at(row)
            # theta compression depends on a challenge; the mock checks the
            # tuple inclusion it stands for instead
            ttuple = tuple(CS.eval_host(e, gv) for e in lk.tables)
            ituple = tuple(CS.eval_host(e, gv) for e in lk.inputs)
            table[ttuple] += 1
            inputs.append((row, ituple))
        for row, ituple in inputs:
            if table[ituple] == 0:
                failures.append(
                    f"lookup '{lk.name}': row {row} input {ituple} not in table"
                )
                if len(failures) >= max_failures:
                    break

    for (ka, ia, ra), (kb, ib, rb) in copies or []:
        va = host[ka][ia][ra]
        vb = host[kb][ib][rb]
        if va != vb:
            failures.append(
                f"copy ({ka}{ia}[{ra}]) == ({kb}{ib}[{rb}]) violated: {va} != {vb}"
            )

    return failures
