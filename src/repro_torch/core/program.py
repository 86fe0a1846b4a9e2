"""User-code injection: tensor bytecode for composite-stream transforms.

ServIoTicy lets tenants attach JavaScript snippets to composite streams;
the snippets use basic operators, functions of the Math object and
shorthand conditionals (paper §IV-A).  The engine maps that closed
expression language onto a tiny register VM whose programs are *data*:
an ``(L, 4)`` int32 instruction table plus a ``(K,)`` float32 constant
pool per stream, so injecting new user code is a table edit.

This module is the PyTorch port of the JAX package's ``repro.core.program``:
the expression compiler, ``assemble``, ``empty_program`` and the pure-Python
oracle ``execute_py`` are copied unchanged; ``execute``/``execute_batch``
are the VM written in plain torch over a batch of lanes, bit-identical to
the JAX VM under the float policy below.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Instruction set
# --------------------------------------------------------------------------
# Encoding: (op, dst, a, b).  `a`/`b` index the register file except for
# CONST where `a` indexes the per-stream constant pool.

OP_NOP = 0
OP_MOV = 1      # dst = r[a]
OP_CONST = 2    # dst = consts[a]
OP_ADD = 3      # dst = r[a] + r[b]
OP_SUB = 4
OP_MUL = 5
OP_DIV = 6      # safe: r[b]==0 -> 0
OP_MIN = 7
OP_MAX = 8
OP_NEG = 9
OP_ABS = 10
OP_EXP = 11
OP_LOG = 12     # safe: log(max(x, tiny))
OP_SQRT = 13    # safe: sqrt(max(x, 0))
OP_SIN = 14
OP_COS = 15
OP_FLOOR = 16
OP_POW = 17     # sign-safe |a|^b * sign(a) when b integral-ish; plain otherwise
OP_LT = 18
OP_LE = 19
OP_EQ = 20
OP_NE = 21
OP_AND = 22     # boolean (nonzero) and
OP_OR = 23
OP_NOT = 24
OP_SELECT = 25  # dst = r[a] != 0 ? r[b] : r[dst]
OP_ROUND = 26
OP_SIGN = 27
OP_TANH = 28

N_OPS = 29

_EPS = 1e-30
FLT_MIN = float(np.finfo(np.float32).tiny)

# --------------------------------------------------------------------------
# Float policy: subnormals flush to a zero of the same sign
# --------------------------------------------------------------------------
# XLA on the CPU runs with flush-to-zero and denormals-are-zero set, so the
# JAX package's VM never sees or makes a subnormal float: every arithmetic
# op (add, sub, mul, div, min, max, compare, floor, round, sign, the
# transcendentals) reads a subnormal input as a zero of the same sign and
# writes a subnormal result as one.  The bit moves (MOV, CONST, NEG, ABS
# and the chosen operand of SELECT) keep subnormals as they are.  Torch
# keeps subnormals on both the CPU and the GPU, so this VM flushes
# explicitly with :func:`flush`: the inputs of each arithmetic op, and its
# result where one can be subnormal.  The CUDA kernels apply the same rule
# with the same explicit flushes (and are built with ``-ftz=true``), so a
# kernel and this plain version agree bit for bit on the card too.
#
# Two more rules the JAX VM follows and torch does not by default:
# min/max propagate NaN and order -0.0 below +0.0 (IEEE 754-2019
# minimum/maximum), and sign(-0.0) is -0.0 and sign(NaN) is NaN.  Both
# are written out below rather than taken from torch.minimum/torch.sign.


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to a zero of the same sign; every other
    value (zeros, normals, inf, NaN) unchanged."""
    return torch.where(x.abs() < FLT_MIN, torch.copysign(torch.zeros_like(x), x),
                       x)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE minimum: NaN if either is NaN, and -0.0 below +0.0."""
    pick_a = (a < b) | ((a == b) & torch.signbit(a))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b,
                       torch.where(pick_a, a, b))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE maximum: NaN if either is NaN, and +0.0 above -0.0."""
    pick_a = (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b,
                       torch.where(pick_a, a, b))


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1 for nonzero, the signed zero itself for zeros,
    NaN for NaN (``torch.sign`` gives +0.0 for both)."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  ``torch.sqrt`` on the CPU
    may be off by one ulp (its vectorised path); a float64 root rounded
    once to float32 is exact (53 >= 2 * 24 + 2 bits), and is what XLA and
    the kernels' ``__fsqrt_rn`` give."""
    return torch.sqrt(x.double()).float()


def _bool(x: torch.Tensor) -> torch.Tensor:
    return (flush(x) != 0.0).to(torch.float32)


def _branches(av, bv, dv, ca):
    """Value of every opcode on (W,) operand lanes, keyed by opcode."""
    fa, fb = flush(av), flush(bv)
    tiny = bv.abs() < _EPS
    f32 = torch.float32
    return {
        OP_NOP: lambda: dv,
        OP_MOV: lambda: av,
        OP_CONST: lambda: ca,
        OP_ADD: lambda: flush(fa + fb),
        OP_SUB: lambda: flush(fa - fb),
        OP_MUL: lambda: flush(fa * fb),
        OP_DIV: lambda: torch.where(
            tiny, torch.zeros_like(fa),
            flush(fa / torch.where(tiny, torch.ones_like(fb), fb))),
        OP_MIN: lambda: minimum(fa, fb),
        OP_MAX: lambda: maximum(fa, fb),
        OP_NEG: lambda: -av,
        OP_ABS: lambda: av.abs(),
        OP_EXP: lambda: flush(torch.exp(fa)),
        OP_LOG: lambda: flush(torch.log(maximum(fa, torch.full_like(fa, _EPS)))),
        OP_SQRT: lambda: _sqrt(maximum(fa, torch.zeros_like(fa))),
        OP_SIN: lambda: flush(torch.sin(fa)),
        OP_COS: lambda: flush(torch.cos(fa)),
        OP_FLOOR: lambda: torch.floor(fa),
        OP_POW: lambda: flush(sign(fa) * flush(torch.pow(
            flush(fa.abs() + _EPS), fb))),
        OP_LT: lambda: (fa < fb).to(f32),
        OP_LE: lambda: (fa <= fb).to(f32),
        OP_EQ: lambda: (fa == fb).to(f32),
        OP_NE: lambda: (fa != fb).to(f32),
        OP_AND: lambda: _bool(av) * _bool(bv),
        OP_OR: lambda: maximum(_bool(av), _bool(bv)),
        OP_NOT: lambda: 1.0 - _bool(av),
        OP_SELECT: lambda: torch.where(fa != 0.0, bv, dv),
        OP_ROUND: lambda: torch.round(fa),
        OP_SIGN: lambda: sign(fa),
        OP_TANH: lambda: flush(torch.tanh(fa)),
    }


def read_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """XLA's read of a dynamic index into an axis of ``n``: a negative
    index wraps once, then the result clamps into ``[0, n - 1]``."""
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1).long()


def write_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """XLA's scatter of a dynamic index: a negative index wraps once and
    whatever is still out of range is dropped — mapped here to ``n``, the
    pad column the caller slices off."""
    j = torch.where(i < 0, i + n, i)
    return torch.where((j >= 0) & (j < n), j, n).long()


def step_batch(ops: Sequence[int], prog_i: torch.Tensor, consts: torch.Tensor,
               regs: torch.Tensor) -> torch.Tensor:
    """One instruction for every lane: ``prog_i`` (W, 4), ``consts``
    (W, K), ``regs`` (W, R).  Opcodes are clipped into ``[0, N_OPS)`` like
    ``jax.lax.switch``; an opcode outside ``ops`` runs as NOP.  Returns
    the new register file (a new tensor)."""
    W, R = regs.shape
    K = consts.shape[1]
    op = torch.clamp(prog_i[:, 0], 0, N_OPS - 1)
    dst, a, b = prog_i[:, 1], prog_i[:, 2], prog_i[:, 3]
    av = regs.gather(1, read_index(a, R)[:, None])[:, 0]
    bv = regs.gather(1, read_index(b, R)[:, None])[:, 0]
    dv = regs.gather(1, read_index(dst, R)[:, None])[:, 0]
    ca = consts.gather(1, read_index(a, K)[:, None])[:, 0]
    fns = _branches(av, bv, dv, ca)
    val = dv
    for code in ops:
        if code != OP_NOP:
            val = torch.where(op == code, fns[code](), val)
    padded = torch.cat([regs, regs.new_zeros((W, 1))], dim=1)
    padded.scatter_(1, write_index(dst, R)[:, None], val[:, None])
    return padded[:, :R]


ALL_OPS = tuple(range(N_OPS))


def execute_batch(progs: torch.Tensor, consts: torch.Tensor,
                  regs: torch.Tensor, ops: Sequence[int] = ALL_OPS
                  ) -> torch.Tensor:
    """Run one bytecode program per lane — the JAX package's vmapped
    ``execute`` in plain torch.

    progs:  (W, L, 4) int32 — (op, dst, a, b); NOP-padded.
    consts: (W, K) float32 constant pools.
    regs:   (W, R) float32 initial register files.
    Returns the final register files.  All L steps run, as the JAX
    package's ``fori_loop`` does, so nothing is read back to the host; a
    caller that knows a shorter bound passes the table cut to it (a NOP
    writes its ``dst`` back unchanged, so a NOP tail is the identity —
    see :func:`program_steps`)."""
    if progs.shape[0] == 0:
        return regs
    for i in range(progs.shape[1]):
        regs = step_batch(ops, progs[:, i, :], consts, regs)
    return regs


def program_steps(progs: np.ndarray) -> int:
    """Steps a host ``(..., L, 4)`` program table needs (``(N, L, 4)``, or
    ``(n_shards, n_local, L, 4)`` sharded): one past the last instruction
    that is not a NOP in any row (at least 1).  Cutting the table to this
    many steps leaves every program's result unchanged."""
    ops = np.asarray(progs)[..., 0]
    live = np.nonzero((ops.reshape(-1, ops.shape[-1]) != OP_NOP)
                      .any(axis=0))[0]
    return int(live[-1]) + 1 if live.size else 1


def execute(prog: torch.Tensor, consts: torch.Tensor, regs: torch.Tensor
            ) -> torch.Tensor:
    """Run one bytecode program: ``prog`` (L, 4), ``consts`` (K,),
    ``regs`` (R,).  Returns the final register file."""
    return execute_batch(prog[None], consts[None], regs[None])[0]


# --------------------------------------------------------------------------
# Expression compiler:  "(\$temp - 32) * 5 / 9"  →  bytecode
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_$][A-Za-z0-9_.\[\]$]*)"
    r"|(?P<op>\*\*|<=|>=|==|!=|&&|\|\||[-+*/%(),?:<>!]))"
)

_FUNCS1 = {
    "abs": OP_ABS, "exp": OP_EXP, "log": OP_LOG, "sqrt": OP_SQRT,
    "sin": OP_SIN, "cos": OP_COS, "floor": OP_FLOOR, "round": OP_ROUND,
    "sign": OP_SIGN, "tanh": OP_TANH, "neg": OP_NEG,
}
_FUNCS2 = {"min": OP_MIN, "max": OP_MAX, "pow": OP_POW}


class CompileError(ValueError):
    pass


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise CompileError(f"bad token at {src[pos:pos+12]!r}")
        pos = m.end()
        for kind in ("num", "name", "op"):
            if m.group(kind) is not None:
                out.append((kind, m.group(kind)))
                break
    out.append(("eof", ""))
    return out


@dataclasses.dataclass
class _Ctx:
    toks: List[Tuple[str, str]]
    i: int
    env: Dict[str, int]          # identifier -> register index
    consts: List[float]
    code: List[Tuple[int, int, int, int]]
    next_tmp: int
    tmp_hi: int

    def peek(self):
        return self.toks[self.i]

    def eat(self, val=None):
        kind, tok = self.toks[self.i]
        if val is not None and tok != val:
            raise CompileError(f"expected {val!r}, got {tok!r}")
        self.i += 1
        return kind, tok

    def tmp(self) -> int:
        if self.next_tmp >= self.tmp_hi:
            raise CompileError("out of temporary registers")
        r = self.next_tmp
        self.next_tmp += 1
        return r

    def const(self, v: float) -> int:
        for j, c in enumerate(self.consts):
            if c == v:
                return j
        self.consts.append(v)
        return len(self.consts) - 1

    def emit(self, op, dst, a=0, b=0):
        self.code.append((op, dst, a, b))


# precedence-climbing parser ------------------------------------------------

_BINOPS = {
    "||": (1, OP_OR), "&&": (2, OP_AND),
    "==": (3, OP_EQ), "!=": (3, OP_NE),
    "<": (4, OP_LT), "<=": (4, OP_LE), ">": (4, None), ">=": (4, None),
    "+": (5, OP_ADD), "-": (5, OP_SUB),
    "*": (6, OP_MUL), "/": (6, OP_DIV), "%": (6, None),
    "**": (8, OP_POW),
}


def _parse_primary(ctx: _Ctx) -> int:
    kind, tok = ctx.peek()
    if tok == "(":
        ctx.eat("(")
        r = _parse_expr(ctx, 0)
        ctx.eat(")")
        return r
    if tok == "-":
        ctx.eat("-")
        r = _parse_primary(ctx)
        d = ctx.tmp()
        ctx.emit(OP_NEG, d, r)
        return d
    if tok == "!":
        ctx.eat("!")
        r = _parse_primary(ctx)
        d = ctx.tmp()
        ctx.emit(OP_NOT, d, r)
        return d
    if kind == "num":
        ctx.eat()
        d = ctx.tmp()
        ctx.emit(OP_CONST, d, ctx.const(float(tok)))
        return d
    if kind == "name":
        ctx.eat()
        if ctx.peek()[1] == "(":  # function call
            name = tok.lstrip("$")
            ctx.eat("(")
            args = [_parse_expr(ctx, 0)]
            while ctx.peek()[1] == ",":
                ctx.eat(",")
                args.append(_parse_expr(ctx, 0))
            ctx.eat(")")
            d = ctx.tmp()
            if name in _FUNCS1 and len(args) == 1:
                ctx.emit(_FUNCS1[name], d, args[0])
            elif name in _FUNCS2 and len(args) == 2:
                ctx.emit(_FUNCS2[name], d, args[0], args[1])
            else:
                raise CompileError(f"unknown function {name}/{len(args)}")
            return d
        key = tok.lstrip("$")
        if key not in ctx.env:
            raise CompileError(f"unknown identifier {tok!r}; env={sorted(ctx.env)}")
        return ctx.env[key]
    raise CompileError(f"unexpected token {tok!r}")


def _parse_expr(ctx: _Ctx, min_prec: int) -> int:
    lhs = _parse_primary(ctx)
    while True:
        kind, tok = ctx.peek()
        if tok == "?":  # ternary, lowest precedence, right-assoc
            if min_prec > 0:
                return lhs
            ctx.eat("?")
            t_val = _parse_expr(ctx, 0)
            ctx.eat(":")
            f_val = _parse_expr(ctx, 0)
            d = ctx.tmp()
            ctx.emit(OP_MOV, d, f_val)
            ctx.emit(OP_SELECT, d, lhs, t_val)
            lhs = d
            continue
        if tok not in _BINOPS:
            return lhs
        prec, op = _BINOPS[tok]
        if prec < min_prec:
            return lhs
        ctx.eat()
        rhs = _parse_expr(ctx, prec + 1)
        d = ctx.tmp()
        if tok == ">":
            ctx.emit(OP_LT, d, rhs, lhs)
        elif tok == ">=":
            ctx.emit(OP_LE, d, rhs, lhs)
        elif tok == "%":
            # a % b  ==  a - floor(a/b)*b
            q = ctx.tmp()
            ctx.emit(OP_DIV, q, lhs, rhs)
            ctx.emit(OP_FLOOR, q, q)
            ctx.emit(OP_MUL, q, q, rhs)
            ctx.emit(OP_SUB, d, lhs, q)
        else:
            ctx.emit(op, d, lhs, rhs)
        lhs = d


def compile_expr(
    src: str,
    env: Dict[str, int],
    *,
    result_reg: int,
    tmp_base: int,
    tmp_count: int,
) -> Tuple[List[Tuple[int, int, int, int]], List[float]]:
    """Compile one expression to bytecode leaving its value in ``result_reg``.

    env maps bare identifier names (channel refs, ``prev``, ``ts`` ...) to
    register indices.  Temporaries are allocated in
    [tmp_base, tmp_base + tmp_count).
    """
    ctx = _Ctx(
        toks=_tokenize(src), i=0, env=dict(env), consts=[],
        code=[], next_tmp=tmp_base, tmp_hi=tmp_base + tmp_count,
    )
    r = _parse_expr(ctx, 0)
    if ctx.peek()[0] != "eof":
        raise CompileError(f"trailing input at {ctx.peek()[1]!r}")
    ctx.emit(OP_MOV, result_reg, r)
    return ctx.code, ctx.consts


def assemble(
    code: Sequence[Tuple[int, int, int, int]],
    consts: Sequence[float],
    max_len: int,
    max_consts: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad bytecode and constants to the engine's static tables."""
    if len(code) > max_len:
        raise CompileError(f"program too long: {len(code)} > {max_len}")
    if len(consts) > max_consts:
        raise CompileError(f"too many constants: {len(consts)} > {max_consts}")
    prog = np.zeros((max_len, 4), np.int32)
    for i, ins in enumerate(code):
        prog[i] = ins
    cst = np.zeros((max_consts,), np.float32)
    cst[: len(consts)] = consts
    return prog, cst


def empty_program(max_len: int, max_consts: int) -> Tuple[np.ndarray, np.ndarray]:
    """The all-NOP program + zeroed constant pool: the instruction-pool
    image of a simple (non-composite) or vacated table row.  The admission
    plane writes this when a stream without user code claims a row, so live
    admission and ``Registry.build_tables`` produce identical images."""
    return np.zeros((max_len, 4), np.int32), np.zeros((max_consts,), np.float32)


# --------------------------------------------------------------------------
# Pure-python oracle (used by tests / hypothesis)
# --------------------------------------------------------------------------

def execute_py(prog: np.ndarray, consts: np.ndarray, regs: np.ndarray) -> np.ndarray:
    regs = np.asarray(regs, np.float32).copy()
    consts = np.asarray(consts, np.float32)

    def booly(x):
        return 1.0 if x != 0 else 0.0

    for op, dst, a, b in np.asarray(prog, np.int64):
        r = regs
        if op == OP_NOP:
            continue
        elif op == OP_MOV:
            v = r[a]
        elif op == OP_CONST:
            v = consts[a]
        elif op == OP_ADD:
            v = r[a] + r[b]
        elif op == OP_SUB:
            v = r[a] - r[b]
        elif op == OP_MUL:
            v = r[a] * r[b]
        elif op == OP_DIV:
            v = 0.0 if abs(r[b]) < _EPS else r[a] / r[b]
        elif op == OP_MIN:
            v = min(r[a], r[b])
        elif op == OP_MAX:
            v = max(r[a], r[b])
        elif op == OP_NEG:
            v = -r[a]
        elif op == OP_ABS:
            v = abs(r[a])
        elif op == OP_EXP:
            v = math.exp(min(r[a], 80.0)) if r[a] < 80 else math.exp(80.0)
            v = np.float32(np.exp(np.float32(r[a])))
        elif op == OP_LOG:
            v = np.float32(np.log(max(np.float32(r[a]), _EPS)))
        elif op == OP_SQRT:
            v = math.sqrt(max(r[a], 0.0))
        elif op == OP_SIN:
            v = np.float32(np.sin(np.float32(r[a])))
        elif op == OP_COS:
            v = np.float32(np.cos(np.float32(r[a])))
        elif op == OP_FLOOR:
            v = math.floor(r[a])
        elif op == OP_POW:
            v = np.sign(r[a]) * np.power(np.abs(np.float32(r[a])) + np.float32(_EPS), np.float32(r[b]))
        elif op == OP_LT:
            v = 1.0 if r[a] < r[b] else 0.0
        elif op == OP_LE:
            v = 1.0 if r[a] <= r[b] else 0.0
        elif op == OP_EQ:
            v = 1.0 if r[a] == r[b] else 0.0
        elif op == OP_NE:
            v = 1.0 if r[a] != r[b] else 0.0
        elif op == OP_AND:
            v = booly(r[a]) * booly(r[b])
        elif op == OP_OR:
            v = max(booly(r[a]), booly(r[b]))
        elif op == OP_NOT:
            v = 1.0 - booly(r[a])
        elif op == OP_SELECT:
            v = r[b] if r[a] != 0 else r[dst]
        elif op == OP_ROUND:
            v = np.float32(np.round(np.float32(r[a])))
        elif op == OP_SIGN:
            v = np.sign(r[a])
        elif op == OP_TANH:
            v = np.float32(np.tanh(np.float32(r[a])))
        else:
            raise ValueError(f"bad opcode {op}")
        regs[dst] = np.float32(v)
    return regs
