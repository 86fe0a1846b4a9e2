"""The port's fused-round references against the JAX package's: the
port's ``pop_dispatch_ref`` + ``apply_programs_ref`` (what
``fused_stages`` runs on the CPU, and the oracle of the CUDA kernel pair)
equal ``repro``'s ``fused_stages`` through its jnp refs and through its
Pallas kernel in interpret mode, bitwise — NaN, inf, -0.0 and subnormal
payloads, out-of-range sids, revoked rows and over-range operands
included — and the port's free-slot search equals ``jnp.nonzero``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU ops here are tiny: one thread, so that parallel test workers
# do not contend for the cores through torch's thread pools
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.kernels.round_fuse import ref as jref  # noqa: E402
from repro.kernels.round_fuse.ops import fused_stages as j_fused  # noqa: E402
from repro_torch.core import EngineConfig as PConfig  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.kernels.round_fuse import ref as pref  # noqa: E402
from repro_torch.kernels.round_fuse.ops import fused_stages  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _case(Q, N, C, B, F, M, L, K=8, T=4, seed=0):
    """Adversarial fused-round inputs (as tests/test_kernels.py builds
    them): out-of-range sids, retired slots, revoked rows, inf/NaN/-0.0
    and subnormal payloads, random fusable bytecode with over-range
    operands."""
    rng = np.random.default_rng(seed)
    kw = dict(n_streams=N, channels=C, max_in=M, max_out=F, batch=B,
              queue=Q, prog_len=L, n_consts=K, n_temps=4)
    jl = jref.RegLayout.from_cfg(JConfig(**kw))
    pl = pref.RegLayout.from_cfg(PConfig(**kw))
    assert tuple(jl) == tuple(pl)
    R = pl.n_regs
    vals = rng.standard_normal((Q, C)).astype(np.float32)
    vals.ravel()[rng.integers(0, Q * C, 4)] = [np.inf, -0.0, np.nan, 1e-40]
    values = rng.standard_normal((N, C)).astype(np.float32)
    values.ravel()[rng.integers(0, N * C, 3)] = [np.nan, -0.0, -1e-40]
    ops_pool = np.asarray(sorted(pref.FUSABLE_OPS), np.int32)
    c = dict(
        prio=rng.choice([0, 1, 3, 2**31 - 1], Q).astype(np.int32),
        seq=rng.integers(-5, 60, Q).astype(np.int32),
        valid=rng.random(Q) < 0.6,
        tenant=rng.integers(0, T, Q).astype(np.int32),
        w_slot=None,
        sid=rng.integers(0, N + 4, Q).astype(np.int32),
        vals=vals,
        ts=rng.integers(-50, 50, Q).astype(np.int32),
        out_table=rng.integers(-1, N, (N, F)).astype(np.int32),
        in_table=rng.integers(-2, N, (N, M)).astype(np.int32),
        progs=np.stack([rng.choice(ops_pool, (N, L)),
                        rng.integers(0, R + 5, (N, L)),
                        rng.integers(0, R + 5, (N, L)),
                        rng.integers(0, R + 5, (N, L))],
                       axis=-1).astype(np.int32),
        consts=rng.standard_normal((N, K)).astype(np.float32),
        is_comp=rng.random(N) < 0.7,
        active=rng.random(N) < 0.8,
        values=values,
        timestamps=rng.integers(-5, 40, N).astype(np.int32),
    )
    c["w_slot"] = rng.choice([0, 1, 2, 7, 2**15], T).astype(np.int32)[
        c["tenant"]]
    return jl, pl, c


ORDER = ("prio", "seq", "valid", "tenant", "w_slot", "sid", "vals", "ts")
TABLES = ("out_table", "in_table", "progs", "consts", "is_comp", "active",
          "values", "timestamps")


def _flat(out):
    take, pop, wi_t, applied = out
    return [take, *pop, wi_t, *applied]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


SHAPES = [(32, 16, 1, 2, 2, 2, 4), (64, 24, 3, 4, 5, 6, 10),
          (200, 40, 4, 8, 3, 4, 12)]
NAMES = ["take", "e_sid", "e_vals", "e_ts", "e_pop", "e_act", "wi_t",
         "new_vals", "ts_out", "live", "keep", "keep_ts", "passf", "badf"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_path", ["ref", "pallas_interpret"])
def test_fused_refs_match_jax_fused_stages(shape, jax_path):
    Q, N, C, B, F, M, L = shape
    jl, pl, c = _case(*shape, seed=Q + N)
    kw = (dict(use_kernel=False) if jax_path == "ref"
          else dict(use_kernel=True, interpret=True))
    # compiled as one program, as the JAX engine's step runs it
    run = jax.jit(lambda *a: j_fused(*a[:8], B, *a[8:], jl, **kw))
    want = _flat(run(*[jnp.asarray(c[k]) for k in ORDER + TABLES]))
    got = _flat(fused_stages(*[torch.from_numpy(c[k]) for k in ORDER], B,
                             *[torch.from_numpy(c[k]) for k in TABLES], pl))
    for name, a, b in zip(NAMES, want, got):
        assert np.asarray(a).shape == tuple(b.shape), name
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_apply_programs_ref_matches_jax(seed):
    """Stages 2+3 alone on explicit work items (rows, t_sid, sources)."""
    jl, pl, c = _case(48, 30, 3, 6, 4, 5, 14, seed=seed)
    rng = np.random.default_rng(seed + 50)
    W = 40
    rows = rng.integers(0, 30, W).astype(np.int32)
    src = np.where(rng.random(W) < 0.5, c["in_table"][rows, 0],
                   rng.integers(0, 30, W)).astype(np.int32)
    wi = (rows, rows, src, rng.standard_normal((W, 3)).astype(np.float32),
          rng.integers(-10, 50, W).astype(np.int32), rng.random(W) < 0.8)
    tbl = ("in_table", "progs", "consts", "is_comp", "active")
    want = jax.jit(lambda *a: jref.apply_programs_ref(jl, *a))(
        *[jnp.asarray(c[k]) for k in tbl], *[jnp.asarray(a) for a in wi],
        jnp.asarray(c["values"]), jnp.asarray(c["timestamps"]))
    got = pref.apply_programs_ref(
        pl, *[torch.from_numpy(c[k]) for k in tbl],
        *[torch.from_numpy(a) for a in wi], torch.from_numpy(c["values"]),
        torch.from_numpy(c["timestamps"]))
    for name, a, b in zip(NAMES[7:], want, got):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=name)


@pytest.mark.parametrize("X", [1, 7, 40, 70])
@pytest.mark.parametrize("fast", [True, False])
def test_first_free_matches_nonzero(X, fast):
    rng = np.random.default_rng(X)
    q_valid = rng.random(64) < 0.6
    want = np.asarray(jnp.nonzero(~jnp.asarray(q_valid), size=X,
                                  fill_value=64)[0])
    got = PE._first_free(torch.from_numpy(q_valid), X, fast)
    np.testing.assert_array_equal(want, got.numpy())


def test_fusable_rows_match_jax():
    rng = np.random.default_rng(5)
    progs = rng.integers(-2, 31, (50, 6, 4)).astype(np.int32)
    progs[:20, :, 0] = rng.choice(sorted(pref.FUSABLE_OPS), (20, 6))
    progs[:20, :, 1:] = np.abs(progs[:20, :, 1:])
    np.testing.assert_array_equal(jref.fusable_rows(progs),
                                  pref.fusable_rows(progs))
    assert pref.fusable_rows(progs)[:20].all()


# (config overrides, program steps, fits): the engine's defaults and the
# widths of the CUDA tests fit; each of the register file, the program,
# the constant pool and the in-degree can push one CTA past the limit
FIT_LAYOUTS = [
    (dict(), 48, True),
    (dict(channels=3, max_in=4, n_consts=6, n_temps=6), 10, True),
    (dict(channels=1, max_in=2, n_consts=1, n_temps=0), 1, True),
    (dict(), 400, True),
    (dict(), 440, False),
    (dict(n_temps=1700), 48, False),
    (dict(n_consts=1700), 48, False),
    (dict(max_in=400), 16, False),
]


def _fit_layout(over):
    return pref.RegLayout.from_cfg(PConfig(**over))


@pytest.mark.parametrize("over,L,fits", FIT_LAYOUTS)
def test_apply_layout_fit_check(over, L, fits):
    """``check_layout`` raises ``ValueError`` exactly when one CTA's staged
    planes — per item 16 B for each program step (an odd count) and 4 B for
    each register, constant and in_table entry (the last two padded to a
    multiple of four that is no multiple of eight) — exceed the shared
    memory a CTA can hold."""
    from repro_torch.kernels.round_fuse import kernel as rk
    layout = _fit_layout(over)
    K, M = PConfig(**over).n_consts, layout.max_in
    need = rk.apply_smem_bytes(layout, L, K)
    def pad(n):
        return next(p for p in range(n, n + 8) if p % 8 == 4)

    assert need == rk.APPLY_ITEMS * (16 * (L | 1) + 4 * (
        layout.n_regs + pad(K) + pad(M)))
    assert (need <= rk.SMEM_LIMIT) == fits
    if fits:
        rk.check_layout(layout, L, K)
    else:
        with pytest.raises(ValueError, match="shared bytes"):
            rk.check_layout(layout, L, K)


def test_apply_layout_fit_check_at_the_limit():
    """The longest program that fits at the default widths fills the
    limit to within one pitch step (two program steps); one step more
    raises."""
    from repro_torch.kernels.round_fuse import kernel as rk
    layout, K = _fit_layout({}), PConfig().n_consts
    L = 1
    while rk.apply_smem_bytes(layout, L + 1, K) <= rk.SMEM_LIMIT:
        L += 1
    assert L > PConfig().prog_len
    rk.check_layout(layout, L, K)
    assert rk.SMEM_LIMIT - rk.apply_smem_bytes(layout, L, K) \
        < 32 * rk.APPLY_ITEMS
    with pytest.raises(ValueError, match="shared bytes"):
        rk.check_layout(layout, L + 1, K)


@pytest.mark.parametrize("entry", ["apply_programs_call",
                                   "fused_round_call"])
def test_kernel_wrappers_refuse_a_layout_that_does_not_fit(entry):
    """Given CPU tensors and a layout whose CTA does not fit, the kernel
    wrappers raise the layout's ``ValueError`` (not the device's) before
    anything is launched; no path takes the plain version instead."""
    from repro_torch.kernels.round_fuse import kernel as rk
    L = 600
    _, pl, c = _case(32, 16, 3, 2, 2, 4, L, K=6, seed=3)
    assert rk.apply_smem_bytes(pl, L, 6) > rk.SMEM_LIMIT
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    launches = getattr(rk, entry).launches
    with pytest.raises(ValueError, match="shared bytes"):
        if entry == "fused_round_call":
            rk.fused_round_call(*[t[k] for k in ORDER], 2,
                                *[t[k] for k in TABLES], pl)
        else:
            W = 8
            rows = torch.zeros((1, W), dtype=torch.int32)
            rk.apply_programs_call(
                pl, t["in_table"][None], t["progs"][None],
                t["consts"][None], t["is_comp"][None], t["active"][None],
                rows, rows, rows, torch.zeros((1, W, 3)), rows,
                torch.ones((1, W), dtype=torch.bool), t["values"],
                t["timestamps"])
    assert getattr(rk, entry).launches == launches
