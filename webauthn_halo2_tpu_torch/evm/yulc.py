"""Structured Yul -> EVM bytecode compiler (the contracts toolchain).

The port's copy of the JAX package's evm/yulc.py, over the port's
evm/yul_asm.py.

The reference's chain-side layer is Solidity compiled with solc/forge
(contracts/src/*.sol); no solc exists in this image, so the framework
ships its own compiler for the contract dialect it uses: full structured
Yul — functions, `let`/assignments, `if`, `switch`, `for` with
break/continue/leave, and the complete EVM builtin set. The ERC-4337
contract suite (entrypoint/account/factory/paymaster, chain/contracts.py)
is written in this dialect and compiled here to real deployable bytecode,
executed by evm/machine.py.

This complements evm/yul_asm.py, which stays specialized for the
generated verifier's straight-line trace (liveness-based slot reuse over
thousands of single-assignment temporaries); yulc is the general-purpose
compiler for hand-written structured code.

Compilation model
-----------------
* Locals, function parameters and returns live in MEMORY slots statically
  allocated per function (no recursion — checked), starting at
  `locals_base` (default 0x4000; memory below is contract scratch).
  The operand stack is used only transiently inside expressions, so
  arbitrarily deep expressions/calls cannot hit the EVM's 16-slot limit.
* Function call: args are evaluated left-to-right onto the stack, stored
  into the callee's parameter slots (reverse order), then
  PUSH <ret-label>; JUMP <fn-label>. The callee jumps back through the
  return address (sole stack residue); the caller MLOADs the callee's
  return slots.
* Layout: [main body][STOP][functions...]; entry offset 0 is the main
  body, so the compiled blob is directly usable as runtime code.

Constructor arguments are baked by templating the Yul source before
compilation (the same convention the verifier codegen uses for vk
constants), keeping the compiler itself constructor-free.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from .yul_asm import wrap_deploy

# ---------------------------------------------------------------------------
# builtins: name -> (opcode, n_args, has_result)
# ---------------------------------------------------------------------------

BUILTINS: dict[str, tuple[int, int, bool]] = {
    "stop": (0x00, 0, False),
    "add": (0x01, 2, True), "mul": (0x02, 2, True), "sub": (0x03, 2, True),
    "div": (0x04, 2, True), "sdiv": (0x05, 2, True), "mod": (0x06, 2, True),
    "smod": (0x07, 2, True), "addmod": (0x08, 3, True),
    "mulmod": (0x09, 3, True), "exp": (0x0A, 2, True),
    "signextend": (0x0B, 2, True),
    "lt": (0x10, 2, True), "gt": (0x11, 2, True), "slt": (0x12, 2, True),
    "sgt": (0x13, 2, True), "eq": (0x14, 2, True), "iszero": (0x15, 1, True),
    "and": (0x16, 2, True), "or": (0x17, 2, True), "xor": (0x18, 2, True),
    "not": (0x19, 1, True), "byte": (0x1A, 2, True), "shl": (0x1B, 2, True),
    "shr": (0x1C, 2, True), "sar": (0x1D, 2, True),
    "keccak256": (0x20, 2, True),
    "address": (0x30, 0, True), "balance": (0x31, 1, True),
    "origin": (0x32, 0, True), "caller": (0x33, 0, True),
    "callvalue": (0x34, 0, True), "calldataload": (0x35, 1, True),
    "calldatasize": (0x36, 0, True), "calldatacopy": (0x37, 3, False),
    "codesize": (0x38, 0, True), "codecopy": (0x39, 3, False),
    "gasprice": (0x3A, 0, True), "extcodesize": (0x3B, 1, True),
    "extcodecopy": (0x3C, 4, False), "returndatasize": (0x3D, 0, True),
    "returndatacopy": (0x3E, 3, False), "extcodehash": (0x3F, 1, True),
    "blockhash": (0x40, 1, True), "coinbase": (0x41, 0, True),
    "timestamp": (0x42, 0, True), "number": (0x43, 0, True),
    "prevrandao": (0x44, 0, True), "gaslimit": (0x45, 0, True),
    "chainid": (0x46, 0, True), "selfbalance": (0x47, 0, True),
    "basefee": (0x48, 0, True),
    "pop": (0x50, 1, False),
    "mload": (0x51, 1, True), "mstore": (0x52, 2, False),
    "mstore8": (0x53, 2, False), "sload": (0x54, 1, True),
    "sstore": (0x55, 2, False), "msize": (0x59, 0, True),
    "gas": (0x5A, 0, True), "mcopy": (0x5E, 3, False),
    "log0": (0xA0, 2, False), "log1": (0xA1, 3, False),
    "log2": (0xA2, 4, False), "log3": (0xA3, 5, False),
    "log4": (0xA4, 6, False),
    "create": (0xF0, 3, True), "call": (0xF1, 7, True),
    "callcode": (0xF2, 7, True), "return": (0xF3, 2, False),
    "delegatecall": (0xF4, 6, True), "create2": (0xF5, 4, True),
    "staticcall": (0xFA, 6, True), "revert": (0xFD, 2, False),
    "invalid": (0xFE, 0, False), "selfdestruct": (0xFF, 1, False),
}

# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hexnum>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<id>[A-Za-z_$][A-Za-z_$0-9.]*)
  | (?P<assign>:=)
  | (?P<arrow>->)
  | (?P<punct>[(){},])
  | (?P<ws>\s+)
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(src: str) -> list[str]:
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"lex error at {src[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        toks.append(m.group())
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Lit:
    value: int


@dataclass
class Var:
    name: str


@dataclass
class Call:
    fn: str
    args: list


@dataclass
class Let:
    names: list[str]
    expr: object | None


@dataclass
class Assign:
    names: list[str]
    expr: object


@dataclass
class If:
    cond: object
    body: list


@dataclass
class Switch:
    expr: object
    cases: list  # (Lit, body)
    default: list | None


@dataclass
class For:
    init: list
    cond: object
    post: list
    body: list


@dataclass
class Break:
    pass


@dataclass
class Continue:
    pass


@dataclass
class Leave:
    pass


@dataclass
class ExprStmt:
    expr: object


@dataclass
class FuncDef:
    name: str
    params: list[str]
    rets: list[str]
    body: list = field(default_factory=list)


class Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, t: str) -> None:
        got = self.next()
        if got != t:
            raise SyntaxError(f"expected {t!r}, got {got!r} "
                              f"(near {' '.join(self.toks[self.i-3:self.i+3])})")

    def parse_program(self) -> tuple[list, list[FuncDef]]:
        main: list = []
        funcs: list[FuncDef] = []
        while self.peek() is not None:
            if self.peek() == "function":
                funcs.append(self.parse_func())
            else:
                main.append(self.parse_stmt())
        return main, funcs

    def parse_func(self) -> FuncDef:
        self.expect("function")
        name = self.next()
        self.expect("(")
        params = []
        while self.peek() != ")":
            params.append(self.next())
            if self.peek() == ",":
                self.next()
        self.expect(")")
        rets: list[str] = []
        if self.peek() == "->":
            self.next()
            while self.peek() != "{":
                rets.append(self.next())
                if self.peek() == ",":
                    self.next()
        body = self.parse_block()
        return FuncDef(name, params, rets, body)

    def parse_block(self) -> list:
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return stmts

    def parse_stmt(self):
        t = self.peek()
        if t == "{":
            return self.parse_block()  # bare block = stmt list
        if t == "let":
            self.next()
            names = [self.next()]
            while self.peek() == ",":
                self.next()
                names.append(self.next())
            expr = None
            if self.peek() == ":=":
                self.next()
                expr = self.parse_expr()
            return Let(names, expr)
        if t == "if":
            self.next()
            cond = self.parse_expr()
            return If(cond, self.parse_block())
        if t == "switch":
            self.next()
            expr = self.parse_expr()
            cases = []
            default = None
            while self.peek() in ("case", "default"):
                if self.next() == "case":
                    lit = self.parse_expr()
                    assert isinstance(lit, Lit), "case label must be literal"
                    cases.append((lit, self.parse_block()))
                else:
                    default = self.parse_block()
            return Switch(expr, cases, default)
        if t == "for":
            self.next()
            init = self.parse_block()
            cond = self.parse_expr()
            post = self.parse_block()
            body = self.parse_block()
            return For(init, cond, post, body)
        if t == "break":
            self.next()
            return Break()
        if t == "continue":
            self.next()
            return Continue()
        if t == "leave":
            self.next()
            return Leave()
        # assignment or expression statement
        if (self.i + 1 < len(self.toks)
                and re.match(r"[A-Za-z_$]", t)
                and self.toks[self.i + 1] in (":=", ",")):
            # possible multi-assign `a, b := f(...)`
            save = self.i
            names = [self.next()]
            while self.peek() == ",":
                self.next()
                names.append(self.next())
            if self.peek() == ":=":
                self.next()
                return Assign(names, self.parse_expr())
            self.i = save  # not an assignment after all
        return ExprStmt(self.parse_expr())

    def parse_expr(self):
        t = self.next()
        if t.startswith("0x"):
            return Lit(int(t, 16))
        if t.isdigit():
            return Lit(int(t))
        if t.startswith('"'):
            raw = t[1:-1].encode().decode("unicode_escape").encode()
            assert len(raw) <= 32, "string literal too long"
            return Lit(int.from_bytes(raw.ljust(32, b"\0"), "big"))
        if t == "true":
            return Lit(1)
        if t == "false":
            return Lit(0)
        if self.peek() == "(":
            self.next()
            args = []
            while self.peek() != ")":
                args.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            return Call(t, args)
        return Var(t)


# ---------------------------------------------------------------------------
# code generation
# ---------------------------------------------------------------------------

def _push(v: int) -> bytes:
    if v == 0:
        return bytes([0x60, 0])
    nb = (v.bit_length() + 7) // 8
    return bytes([0x5F + nb]) + v.to_bytes(nb, "big")


class YulCompiler:
    def __init__(self, src: str, locals_base: int = 0x4000):
        self.src = src
        self.base = locals_base
        self.code = bytearray()
        self.fixups: list[tuple[int, str]] = []
        self.labels: dict[str, int] = {}
        self.n_lbl = 0
        # per-function state
        self.next_slot = locals_base
        self.fn_info: dict[str, FuncDef] = {}
        self.fn_frames: dict[str, dict[str, int]] = {}  # param/ret slots
        self.scopes: list[dict[str, int]] = [{}]  # lexical block scopes
        self.loop_stack: list[tuple[str, str]] = []  # (continue, break)
        self.cur_fn: str | None = None
        self.call_edges: set[tuple[str, str]] = set()

    # -- labels -------------------------------------------------------------
    def fresh(self, hint: str = "L") -> str:
        self.n_lbl += 1
        return f"{hint}{self.n_lbl}"

    def mark(self, lbl: str) -> None:
        self.labels[lbl] = len(self.code)
        self.code.append(0x5B)  # JUMPDEST

    def push_label(self, lbl: str) -> None:
        self.fixups.append((len(self.code) + 1, lbl))
        self.code += bytes([0x62, 0, 0, 0])  # PUSH3 placeholder

    # -- slots --------------------------------------------------------------
    def _fn_key(self) -> str:
        return self.cur_fn or "$main"

    def slot(self, name: str, declare: bool = False) -> int:
        """Lexically block-scoped variables (Yul semantics: sibling blocks
        may reuse a name; shadowing a visible name is an error). Every
        declaration gets a fresh memory slot — no reuse, which is fine for
        hand-written contract-sized code."""
        if declare:
            for sc in self.scopes:
                if name in sc:
                    raise SyntaxError(
                        f"shadowing/redeclaration of {name} in {self._fn_key()}")
            s = self.next_slot
            self.scopes[-1][name] = s
            self.next_slot += 32
            return s
        for sc in reversed(self.scopes):
            if name in sc:
                return sc[name]
        raise SyntaxError(f"undeclared variable {name} in {self._fn_key()}")

    # -- expressions ---------------------------------------------------------
    def expr(self, node, want_values: int = 1) -> None:
        """Emit code leaving `want_values` results on the stack."""
        if isinstance(node, Lit):
            assert want_values == 1
            self.code += _push(node.value)
            return
        if isinstance(node, Var):
            assert want_values == 1
            self.code += _push(self.slot(node.name))
            self.code.append(0x51)  # MLOAD
            return
        assert isinstance(node, Call)
        if node.fn in BUILTINS:
            op, n_args, has_res = BUILTINS[node.fn]
            assert len(node.args) == n_args, (
                f"{node.fn} expects {n_args} args, got {len(node.args)}")
            produced = 1 if has_res else 0
            assert want_values == produced, (
                f"{node.fn} produces {produced} value(s), context wants "
                f"{want_values}")
            for a in reversed(node.args):
                self.expr(a, 1)
            self.code.append(op)
            return
        # user function call
        fn = self.fn_info.get(node.fn)
        if fn is None:
            raise SyntaxError(f"unknown function {node.fn}")
        self.call_edges.add((self._fn_key(), node.fn))
        assert len(node.args) == len(fn.params), (
            f"{node.fn} expects {len(fn.params)} args")
        assert want_values == len(fn.rets), (
            f"{node.fn} returns {len(fn.rets)} value(s), context wants "
            f"{want_values}")
        # evaluate all args onto the stack first (nested calls cannot
        # clobber the callee's parameter slots mid-evaluation)
        for a in node.args:
            self.expr(a, 1)
        ftab = self.fn_frames[node.fn]
        for p in reversed(fn.params):
            self.code += _push(ftab[p])
            self.code.append(0x52)  # MSTORE
        ret_lbl = self.fresh("R")
        self.push_label(ret_lbl)
        self.push_label(f"$fn_{node.fn}")
        self.code.append(0x56)  # JUMP
        self.mark(ret_lbl)
        for r in fn.rets:
            self.code += _push(ftab[r])
            self.code.append(0x51)  # MLOAD

    # -- statements ----------------------------------------------------------
    def stmt(self, node) -> None:
        if isinstance(node, list):  # block: new lexical scope
            self.scopes.append({})
            for s in node:
                self.stmt(s)
            self.scopes.pop()
        elif isinstance(node, Let):
            for nm in node.names:
                self.slot(nm, declare=True)
            if node.expr is None:
                for nm in node.names:
                    self.code += _push(0)
                    self.code += _push(self.slot(nm))
                    self.code.append(0x52)
            else:
                self.expr(node.expr, len(node.names))
                for nm in reversed(node.names):
                    self.code += _push(self.slot(nm))
                    self.code.append(0x52)
        elif isinstance(node, Assign):
            self.expr(node.expr, len(node.names))
            for nm in reversed(node.names):
                self.code += _push(self.slot(nm))
                self.code.append(0x52)
        elif isinstance(node, If):
            end = self.fresh("IF")
            self.expr(node.cond, 1)
            self.code.append(0x15)  # ISZERO
            self.push_label(end)
            self.code.append(0x57)  # JUMPI
            self.stmt(node.body)
            self.mark(end)
        elif isinstance(node, Switch):
            end = self.fresh("SWEND")
            self.expr(node.expr, 1)
            case_lbls = []
            for lit, _ in node.cases:
                lbl = self.fresh("CASE")
                case_lbls.append(lbl)
                self.code.append(0x80)  # DUP1
                self.code += _push(lit.value)
                self.code.append(0x14)  # EQ
                self.push_label(lbl)
                self.code.append(0x57)  # JUMPI
            self.code.append(0x50)  # POP scrutinee
            if node.default is not None:
                self.stmt(node.default)
            self.push_label(end)
            self.code.append(0x56)  # JUMP
            for lbl, (_, body) in zip(case_lbls, node.cases):
                self.mark(lbl)
                self.code.append(0x50)  # POP scrutinee
                self.stmt(body)
                self.push_label(end)
                self.code.append(0x56)
            self.mark(end)
        elif isinstance(node, For):
            # the init block's scope extends over cond/post/body (Yul rule)
            self.scopes.append({})
            for s in node.init:
                self.stmt(s)
            cond_lbl = self.fresh("FORC")
            post_lbl = self.fresh("FORP")
            end_lbl = self.fresh("FORE")
            self.mark(cond_lbl)
            self.expr(node.cond, 1)
            self.code.append(0x15)  # ISZERO
            self.push_label(end_lbl)
            self.code.append(0x57)  # JUMPI
            self.loop_stack.append((post_lbl, end_lbl))
            self.stmt(node.body)
            self.loop_stack.pop()
            self.mark(post_lbl)
            self.stmt(node.post)
            self.push_label(cond_lbl)
            self.code.append(0x56)
            self.mark(end_lbl)
            self.scopes.pop()
        elif isinstance(node, Break):
            assert self.loop_stack, "break outside loop"
            self.push_label(self.loop_stack[-1][1])
            self.code.append(0x56)
        elif isinstance(node, Continue):
            assert self.loop_stack, "continue outside loop"
            self.push_label(self.loop_stack[-1][0])
            self.code.append(0x56)
        elif isinstance(node, Leave):
            assert self.cur_fn, "leave outside function"
            self.push_label(f"$ret_{self.cur_fn}")
            self.code.append(0x56)
        elif isinstance(node, ExprStmt):
            self.expr(node.expr, 0)
        else:
            raise TypeError(f"unknown stmt {node!r}")

    # -- top level -----------------------------------------------------------
    def compile(self) -> bytes:
        main, funcs = Parser(tokenize(self.src)).parse_program()
        for f in funcs:
            if f.name in self.fn_info:
                raise SyntaxError(f"duplicate function {f.name}")
            self.fn_info[f.name] = f
            # pre-allocate parameter/return slots (params first, rets after)
            frame: dict[str, int] = {}
            for nm in list(f.params) + list(f.rets):
                if nm in frame:
                    raise SyntaxError(f"duplicate param/ret {nm} in {f.name}")
                frame[nm] = self.next_slot
                self.next_slot += 32
            self.fn_frames[f.name] = frame

        # main body
        self.stmt(main)
        self.code.append(0x00)  # STOP (fallthrough guard)

        # functions
        for f in funcs:
            self.cur_fn = f.name
            self.scopes = [dict(self.fn_frames[f.name])]
            self.labels[f"$fn_{f.name}"] = len(self.code)
            self.code.append(0x5B)  # JUMPDEST
            ftab = self.fn_frames[f.name]
            # zero-init return slots (params were stored by the caller)
            for r in f.rets:
                self.code += _push(0)
                self.code += _push(ftab[r])
                self.code.append(0x52)
            self.stmt(f.body)
            self.mark(f"$ret_{f.name}")
            self.code.append(0x56)  # JUMP via return address on stack
        self.cur_fn = None
        self.scopes = [{}]

        self._check_no_recursion()

        for off, lbl in self.fixups:
            addr = self.labels[lbl]
            assert addr < (1 << 24)
            self.code[off:off + 3] = addr.to_bytes(3, "big")
        return bytes(self.code)

    def _check_no_recursion(self) -> None:
        """Locals are statically allocated, so recursion (direct or mutual)
        would corrupt frames — reject it at compile time."""
        adj: dict[str, set[str]] = {}
        for a, b in self.call_edges:
            adj.setdefault(a, set()).add(b)

        state: dict[str, int] = {}  # 1 = in-stack, 2 = done

        def visit(u: str, path: list[str]):
            state[u] = 1
            for v in adj.get(u, ()):
                if state.get(v) == 1:
                    raise SyntaxError(
                        f"recursion detected: {' -> '.join(path + [v])}")
                if state.get(v, 0) == 0:
                    visit(v, path + [v])
            state[u] = 2

        for u in list(adj):
            if state.get(u, 0) == 0:
                visit(u, [u])


def compile_runtime(src: str, locals_base: int = 0x4000) -> bytes:
    """Structured Yul source -> runtime bytecode."""
    return YulCompiler(src, locals_base).compile()


def compile_contract(src: str, locals_base: int = 0x4000) -> tuple[bytes, bytes]:
    """Structured Yul source -> (deploy_bytecode, runtime_bytecode)."""
    runtime = compile_runtime(src, locals_base)
    return wrap_deploy(runtime), runtime
