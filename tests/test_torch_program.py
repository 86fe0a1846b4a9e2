"""The port's expression compiler and bytecode VM against the JAX
package's: identical bytecode and constants for the same expressions, a
bitwise-identical VM on random fusable bytecode (over-range and negative
operands included), transcendental opcodes within a stated ulp bound, and
the float-policy corner cases (sign, subnormals, NaN in min/max, round
half to even) held against what XLA on the CPU computes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU ops here are tiny: one thread, so that parallel test workers
# do not contend for the cores through torch's thread pools
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import program as jvm  # noqa: E402
from repro_torch.core import program as tvm  # noqa: E402

ENV = {"x": 0, "y": 1, "z": 2}
# expressions of tests/test_program_vm.py plus one of every construct
EXPRS = [
    "(x - 32) * 5 / 9", "x % 3", "x +", "unknown_name", "f(x)",
    "(x ? y : z)", "min(x, y) + max(y, z) * abs(z)", "(-x) + (!y)",
    "x < y && y <= z || z >= x", "x > y", "x == y", "x != y",
    "floor(x) + round(y) + sign(z)", "sqrt(x) / (y - 1.5e-3)",
    "tanh(x) + exp(y) - log(z) * sin(x) / cos(y)", "pow(x, 2) + x ** y",
    "((x + 1) * (y - 2)) / ((z + 3) * (x - 4))", "neg(x) ? 2.5e10 : -7",
]
TRANSCENDENTAL = {jvm.OP_EXP: 2, jvm.OP_LOG: 2, jvm.OP_SIN: 2,
                  jvm.OP_COS: 2, jvm.OP_POW: 2, jvm.OP_TANH: 8}   # max ulp


def _compile(mod, src):
    try:
        return mod.compile_expr(src, ENV, result_reg=3, tmp_base=4,
                                tmp_count=24)
    except mod.CompileError as e:
        return ("error", str(e))


@pytest.mark.parametrize("src", EXPRS)
def test_compiler_emits_identical_bytecode(src):
    want, got = _compile(jvm, src), _compile(tvm, src)
    assert got == want
    if want[0] != "error":
        for a, b in zip(jvm.assemble(*want, 48, 16), tvm.assemble(*got, 48, 16)):
            np.testing.assert_array_equal(a, b)


def _run_both(progs, consts, regs, ops=None):
    want = np.asarray(jvm.execute_batch(jnp.asarray(progs),
                                        jnp.asarray(consts),
                                        jnp.asarray(regs)))
    kw = {} if ops is None else {"ops": ops}
    got = tvm.execute_batch(torch.from_numpy(progs), torch.from_numpy(consts),
                            torch.from_numpy(regs), **kw).numpy()
    return want, got


def _assert_bits(want, got):
    """Bitwise, except that a NaN produced by arithmetic matches any NaN:
    its payload is the host's choice (x86 and CUDA differ), while NaNs that
    are only moved keep their bits in both VMs."""
    both_nan = np.isnan(want) & np.isnan(got)
    bad = (want.view(np.int32) != got.view(np.int32)) & ~both_nan
    assert not bad.any(), np.argwhere(bad)[:5]


def _random_case(seed, W=256, L=12, R=20, K=5, ops=None):
    rng = np.random.default_rng(seed)
    pool = np.asarray(sorted(ops if ops is not None else range(jvm.N_OPS)))
    progs = np.stack([rng.choice(pool, (W, L)),
                      rng.integers(-25, R + 6, (W, L)),
                      rng.integers(-25, R + 6, (W, L)),
                      rng.integers(-25, R + 6, (W, L))],
                     axis=-1).astype(np.int32)
    consts = rng.standard_normal((W, K)).astype(np.float32)
    regs = rng.standard_normal((W, R)).astype(np.float32)
    for val, p in ((0.0, 0.1), (-0.0, 0.05), (np.nan, 0.05), (np.inf, 0.02),
                   (1e-40, 0.05), (-1e-40, 0.03), (1.5e-38, 0.05)):
        regs[rng.random((W, R)) < p] = val
    return progs, consts, regs


FUSABLE = sorted(set(range(jvm.N_OPS)) - set(TRANSCENDENTAL))


@pytest.mark.parametrize("seed", range(6))
def test_vm_bitwise_on_fusable_bytecode(seed):
    progs, consts, regs = _random_case(seed, ops=FUSABLE)
    _assert_bits(*_run_both(progs, consts, regs))


def test_vm_clips_opcodes_like_lax_switch():
    """Opcodes below 0 run NOP and above 28 run TANH (jnp.clip)."""
    progs, consts, regs = _random_case(11, ops=[-4, -1, 29, 40, 3, 1])
    regs = np.clip(np.nan_to_num(regs), -5, 5)
    want, got = _run_both(progs, consts, regs)
    assert np.abs(want - got).max() < 1e-5


@pytest.mark.parametrize("op", sorted(TRANSCENDENTAL))
def test_transcendental_within_ulp_bound(op):
    """EXP/LOG/SIN/COS/POW/TANH: the two libraries' float32 routines
    differ in their last bits, so these agree within the pinned ulp bound
    (normal-range inputs) rather than bitwise."""
    rng = np.random.default_rng(op)
    W = 4000
    progs = np.zeros((W, 1, 4), np.int32)
    progs[:, 0] = [op, 2, 0, 1]
    regs = np.zeros((W, 4), np.float32)
    regs[:, 0] = rng.uniform(-10, 10, W)
    regs[:, 1] = rng.uniform(-3, 3, W)
    want, got = _run_both(progs, np.zeros((W, 2), np.float32), regs)
    a, b = want[:, 2], got[:, 2]
    assert (np.isfinite(a) == np.isfinite(b)).all()
    fin = np.isfinite(a)

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    assert np.abs(ordered(a[fin]) - ordered(b[fin])).max() <= TRANSCENDENTAL[op]


FLT_MIN = np.float32(np.finfo(np.float32).tiny)
SUB = np.float32(1e-40)                 # a subnormal float32
CORNERS = [
    # (op, a, b) — each result's bits must equal XLA's on the CPU
    (jvm.OP_SIGN, -0.0, 0.0), (jvm.OP_SIGN, 0.0, 0.0),
    (jvm.OP_SIGN, np.nan, 0.0), (jvm.OP_SIGN, -3.0, 0.0),
    (jvm.OP_SIGN, -SUB, 0.0),
    (jvm.OP_MUL, FLT_MIN, 0.5), (jvm.OP_MUL, -FLT_MIN, 0.5),   # subnormal out
    (jvm.OP_ADD, SUB, 0.0), (jvm.OP_SUB, -SUB, 0.0),           # subnormal in
    (jvm.OP_MUL, SUB, 1e10), (jvm.OP_DIV, FLT_MIN, 0.5),
    (jvm.OP_MIN, -SUB, 0.0), (jvm.OP_MAX, SUB, -SUB),
    (jvm.OP_LT, -SUB, 0.0), (jvm.OP_EQ, SUB, 0.0), (jvm.OP_NOT, SUB, 0.0),
    (jvm.OP_SELECT, SUB, 2.0), (jvm.OP_FLOOR, -SUB, 0.0),
    (jvm.OP_ROUND, -SUB, 0.0), (jvm.OP_SQRT, -SUB, 0.0),
    (jvm.OP_MOV, -SUB, 0.0), (jvm.OP_NEG, SUB, 0.0), (jvm.OP_ABS, -SUB, 0.0),
    (jvm.OP_MIN, np.nan, 1.0), (jvm.OP_MIN, 1.0, np.nan),
    (jvm.OP_MAX, np.nan, 1.0), (jvm.OP_MAX, 1.0, np.nan),
    (jvm.OP_MIN, -0.0, 0.0), (jvm.OP_MIN, 0.0, -0.0),
    (jvm.OP_MAX, -0.0, 0.0), (jvm.OP_MAX, 0.0, -0.0),
    (jvm.OP_ROUND, 2.5, 0.0), (jvm.OP_ROUND, -0.5, 0.0),
    (jvm.OP_ROUND, 1.5, 0.0), (jvm.OP_ROUND, -2.5, 0.0),
    (jvm.OP_DIV, 1.0, 1e-31), (jvm.OP_DIV, -0.0, 0.0),
]


@pytest.fixture(scope="module")
def corner_results():
    """Every corner case as one lane of one batch through both VMs."""
    n = len(CORNERS)
    progs = np.zeros((n, 1, 4), np.int32)
    regs = np.zeros((n, 6), np.float32)
    for i, (op, a, b) in enumerate(CORNERS):
        progs[i, 0] = [op, 3, 0, 1]
        regs[i, :4] = [a, b, 0.0, 7.0]
    want, got = _run_both(progs, np.zeros((n, 2), np.float32), regs)
    return want[:, 3], got[:, 3]


@pytest.mark.parametrize("case", range(len(CORNERS)),
                         ids=[f"op{op}-{a}-{b}" for op, a, b in CORNERS])
def test_float_policy_corner_cases(corner_results, case):
    """sign(-0.0) is -0.0 and sign(NaN) NaN; subnormal inputs of arithmetic
    read as signed zeros and subnormal results flush to signed zeros
    (bit moves keep them); min/max propagate NaN and order -0.0 < +0.0;
    round is half to even — all exactly as XLA computes on the CPU."""
    want, got = (r[case] for r in corner_results)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert want.view(np.int32) == got.view(np.int32), (want, got)


def test_flush_keeps_sign_and_specials():
    x = torch.tensor([1e-40, -1e-40, 0.0, -0.0, 1.0, float("inf"),
                      float("nan"), float(FLT_MIN)], dtype=torch.float32)
    got = tvm.flush(x).numpy()
    np.testing.assert_array_equal(got[:2].view(np.int32), [0, -2**31])
    np.testing.assert_array_equal(got[2:6], [0.0, -0.0, 1.0, np.inf])
    assert np.isnan(got[6]) and got[7] == FLT_MIN
