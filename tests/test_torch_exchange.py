"""The sharded round's two kernel functions of the port against the JAX
package's, bitwise, on numpy-seeded inputs.

``exchange_compact``: the port's plain version (the CPU path and the CUDA
kernel's oracle) against ``repro``'s ``exchange_compact_ref`` and its
Pallas ``exchange_compact_call`` in interpret mode — D in {1, 2, 3, 8},
bucket overflow, every item to one shard, unrouted lanes (and
destinations past D), W not a multiple of 128, -0.0 / NaN / inf /
subnormal payload bits; and the (S, W) sender-batched form the sharded
round calls.  ``apply_programs``: the post-exchange apply with the tables
(``n_local`` rows) and the snapshot (``N`` rows) in two row spaces,
against ``repro``'s ``apply_programs_ref``, one shard at a time and
batched over shards."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels.round_fuse import kernel as jk  # noqa: E402
from repro.kernels.round_fuse import ref as jr  # noqa: E402
from repro_torch.core.config import EngineConfig  # noqa: E402
from repro_torch.kernels.round_fuse import ops as po  # noqa: E402
from repro_torch.kernels.round_fuse import ref as pr  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, f"{name}[{i}]"
        np.testing.assert_array_equal(g, w, err_msg=f"{name}[{i}]")


def _items(rng, W, C, D, mode):
    wi_t = rng.integers(-1, 500, W).astype(np.int32)
    wi_src = rng.integers(-3, 500, W).astype(np.int32)
    wi_ts = rng.integers(-2**31 + 1, 2**31 - 1, W).astype(np.int32)
    wi_its = rng.integers(0, 1 << 20, W).astype(np.int32)
    vals = rng.standard_normal((W, C)).astype(np.float32)
    flat = vals.reshape(-1)
    for x in (np.nan, -0.0, np.inf, -np.inf, 1e-40):
        flat[rng.integers(0, flat.size, 3)] = x
    flat[rng.integers(0, flat.size, 2)] = np.frombuffer(
        np.uint32(0x7fc12345).tobytes(), np.float32)[0]      # NaN payload
    if mode == "mixed":             # a quarter unrouted, some past D
        dest = rng.integers(0, D + 2, W).astype(np.int32)
        dest[rng.random(W) < 0.25] = D
    elif mode == "one":             # every routed item to shard 0
        dest = np.where(rng.random(W) < 0.9, 0, D).astype(np.int32)
    else:                           # nothing routed
        dest = np.full(W, D, np.int32)
    return wi_t, wi_src, wi_ts, wi_its, vals, dest


CASES = [(1, 40, 3, 16, "mixed"), (2, 130, 4, 64, "mixed"),
         (2, 77, 1, 5, "one"), (3, 200, 2, 300, "mixed"),
         (3, 33, 4, 4, "none"), (8, 257, 4, 9, "mixed"),
         (8, 128, 1, 2, "one")]


@pytest.mark.parametrize("D,W,C,E,mode", CASES,
                         ids=[f"D{c[0]}-W{c[1]}-E{c[3]}-{c[4]}" for c in CASES])
def test_exchange_compact_matches_jax_ref_and_pallas(D, W, C, E, mode):
    rng = np.random.default_rng(D * 1000 + W + E)
    items = _items(rng, W, C, D, mode)
    want = jr.exchange_compact_ref(*map(jnp.asarray, items), D, E)
    pallas = jk.exchange_compact_call(*map(jnp.asarray, items), D, E,
                                      interpret=True)
    got = pr.exchange_compact_ref(*map(torch.from_numpy, items), D, E)
    _same("port vs repro ref", got, want)
    _same("port vs Pallas (interpret)", got, pallas)
    routed = items[5] < D
    if mode == "none":
        assert (_bits(got[0]) == -1).all() and not _bits(got[2]).any()
    if mode == "one" and routed.sum() > E:
        assert _bits(got[2]).sum() == routed.sum() - E


def test_exchange_compact_sender_batched():
    """The (S, W) form the sharded round calls equals S separate calls
    of the JAX reference, sender by sender."""
    rng = np.random.default_rng(5)
    S, W, C, E = 4, 96, 4, 20
    per = [_items(rng, W, C, S, "mixed" if s % 2 else "one")
           for s in range(S)]
    stacked = [torch.from_numpy(np.stack(p)) for p in zip(*per)]
    xi, xf, drop = po.exchange_compact(*stacked, S, E)
    assert xi.shape == (S, S, E, 4) and xf.shape == (S, S, E, C)
    for s in range(S):
        want = jr.exchange_compact_ref(*map(jnp.asarray, per[s]), S, E)
        _same(f"sender {s}", (xi[s], xf[s], drop[s]), want)


def _apply_case(rng, cfg, n_tab, n_snap, W):
    M, L, K, C = cfg.max_in, cfg.prog_len, cfg.n_consts, cfg.channels
    R = pr.RegLayout.from_cfg(cfg).n_regs
    ops_pool = np.asarray(sorted(pr.FUSABLE_OPS), np.int32)
    progs = np.stack([rng.choice(ops_pool, (n_tab, L)),
                      rng.integers(0, R + 4, (n_tab, L)),
                      rng.integers(0, R + 4, (n_tab, L)),
                      rng.integers(0, R + 4, (n_tab, L))],
                     axis=-1).astype(np.int32)
    values = rng.standard_normal((n_snap, C)).astype(np.float32)
    values.ravel()[rng.integers(0, values.size, 4)] = np.nan
    values.ravel()[rng.integers(0, values.size, 4)] = -0.0
    return (rng.integers(-2, n_snap + 3, (n_tab, M)).astype(np.int32),
            progs, rng.standard_normal((n_tab, K)).astype(np.float32),
            rng.random(n_tab) < 0.75, rng.random(n_tab) < 0.9,
            rng.integers(0, n_tab, W).astype(np.int32),       # rows
            rng.integers(0, n_snap, W).astype(np.int32),      # t_sid
            rng.integers(-3, n_snap + 3, W).astype(np.int32),
            rng.standard_normal((W, C)).astype(np.float32),
            rng.integers(-5, 40, W).astype(np.int32),
            rng.random(W) < 0.8, values,
            rng.integers(-5, 40, n_snap).astype(np.int32))


@pytest.mark.parametrize("n_tab,n_snap", [(12, 48), (16, 16)])
def test_apply_programs_two_row_spaces(n_tab, n_snap):
    """Tables of ``n_tab`` rows (a shard's ``n_local``) against an
    ``n_snap``-row snapshot: rows index the tables, targets and every
    co-input the snapshot.  Per shard against ``repro``; the shard-batched
    call (what the sharded round makes) equals the per-shard calls."""
    cfg = EngineConfig(n_streams=n_snap, channels=3, max_in=4, prog_len=10,
                       n_consts=6, n_temps=6).validate()
    layout = pr.RegLayout.from_cfg(cfg)
    jlayout = jr.RegLayout.from_cfg(cfg)
    rng = np.random.default_rng(n_tab + n_snap)
    S, W = 3, 70
    shards = [_apply_case(rng, cfg, n_tab, n_snap, W) for _ in range(S)]
    # one snapshot shared by every shard, as the round gathers it
    shards = [c[:11] + shards[0][11:] for c in shards]
    outs = []
    for s, c in enumerate(shards):
        want = jax.jit(jr.apply_programs_ref, static_argnums=0)(
            jlayout, *map(jnp.asarray, c))
        one = [torch.from_numpy(x[None]) for x in c[:11]]     # S = 1
        got = [x[0] for x in po.apply_programs(
            layout, *one, *map(torch.from_numpy, c[11:]))]
        _same(f"shard {s}", got, want)
        outs.append(got)
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*(c[:11]
                                                             for c in shards))]
    batched = po.apply_programs(layout, *stacked,
                                *map(torch.from_numpy, shards[0][11:]))
    for s in range(S):
        _same(f"batched shard {s}", [b[s] for b in batched], outs[s])
