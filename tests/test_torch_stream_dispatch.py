"""The port's stream-dispatch plane against the JAX package's, bitwise.

* Kernel level: the port's ``onehot_gather`` and ``stream_dispatch``
  (their plain versions, which the CUDA kernels equal bit for bit on the
  card) against the JAX package's Pallas ``onehot_gather`` and the
  ``stream_dispatch`` op built on it, run in interpret mode.  Two inputs
  set the Pallas kernel apart from a gather, and the tests pin both:
  the one-hot product turns -0.0 into +0.0 and spreads a non-finite
  table entry over its block's other rows (so float tables with -0.0,
  subnormals or non-finite values are held against the JAX package's
  ``onehot_gather_ref``, a gather), and the JAX ``stream_dispatch_ref``
  clamps out-of-range sids and targets where the op reads zero rows (so
  the port follows the op).
* ``fanout_reference`` has the JAX package's signature and early mask.
* Engine level: the port's engine with ``fanout_fn=make_fanout()`` on
  the CPU against ``repro``'s with ``make_fanout(interpret=True)``:
  staged single-device rounds and a superstep of K = 3, and a 2-shard
  engine on the fused and the staged path (``repro``'s sharded engine
  runs the interpret-mode Pallas fan-out inside its ``shard_map``).
  Every state leaf, stat, sink, spool and dead letter, bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.engine import fanout_reference as j_fanout  # noqa: E402
from repro.distributed.stream_sharding import \
    ShardedStreamEngine as JSharded  # noqa: E402
from repro.kernels.stream_dispatch.kernel import \
    onehot_gather as j_onehot_gather  # noqa: E402
from repro.kernels.stream_dispatch.ops import \
    make_fanout as j_make_fanout  # noqa: E402
from repro.kernels.stream_dispatch.ops import \
    stream_dispatch as j_stream_dispatch  # noqa: E402
from repro.kernels.stream_dispatch.ref import \
    onehot_gather_ref as j_onehot_gather_ref  # noqa: E402
from repro_torch.core.engine import fanout_reference  # noqa: E402
from repro_torch.kernels.stream_dispatch.kernel import \
    word_lanes  # noqa: E402
from repro_torch.kernels.stream_dispatch.ops import (  # noqa: E402
    by_sid_snapshot, make_fanout, onehot_gather, stream_dispatch)

I32_MIN, I32_MAX = -2**31, 2**31 - 1


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- kernels
SWEEP = [(64, 4, 16), (300, 7, 33), (1024, 16, 256), (128, 1, 8)]


@pytest.mark.parametrize("N,F,B", SWEEP)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_onehot_gather_equals_pallas(N, F, B, dtype):
    """The sweep of ``tests/test_kernels.py``: integer tables and finite
    normal floats, ids from -2 to N + 1."""
    rng = np.random.default_rng(N * F + B)
    table = rng.integers(-3, 1000, size=(N, F)).astype(dtype)
    ids = rng.integers(-2, N + 2, size=(B,)).astype(np.int32)
    want = j_onehot_gather(jnp.asarray(table), jnp.asarray(ids),
                           interpret=True)
    got = onehot_gather(_t(table), _t(ids))
    assert got.dtype == torch.float32 and got.shape == (B, F)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_onehot_gather_keeps_float_bits():
    """-0.0, subnormals, NaN payloads and infinities come through as
    their bits, as the JAX package's gather ref gives them; its Pallas
    one-hot product does not (it adds +0.0 products to every row)."""
    rng = np.random.default_rng(5)
    N, F, M = 300, 5, 77
    table = rng.standard_normal((N, F)).astype(np.float32)
    flat = table.reshape(-1)
    specials = np.array([0x80000000, 0x00000001, 0x807fffff, 0x7fc12345,
                         0xffa00001, 0x7f800000, 0xff800000],
                        np.uint32).view(np.float32)
    for x in specials:
        flat[rng.integers(0, flat.size, 6)] = x
    ids = rng.integers(-2, N + 2, M).astype(np.int32)
    got = onehot_gather(_t(table), _t(ids))
    want = j_onehot_gather_ref(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pallas = j_onehot_gather(jnp.asarray(table), jnp.asarray(ids),
                             interpret=True)
    assert not np.array_equal(_bits(got), _bits(pallas))


def _dispatch_case(rng, B, F, n_tab, N, adversarial):
    """Events and tables for ``stream_dispatch``; ``adversarial`` adds
    valid events with sids outside [0, n_tab), out-table entries below -1
    and at or past N, and INT32_MIN/INT32_MAX timestamps."""
    valid = rng.random(B) > 0.3
    ts = rng.integers(I32_MIN + 1, I32_MAX, B).astype(np.int32)
    tstab = rng.integers(I32_MIN + 1, I32_MAX, N).astype(np.int32)
    if not adversarial:
        return (rng.integers(0, n_tab, B).astype(np.int32), ts, valid,
                rng.integers(-1, N, (n_tab, F)).astype(np.int32), tstab)
    sid = rng.integers(-3, n_tab + 3, B).astype(np.int32)
    sid[:4] = (-1, n_tab, n_tab + 2, -3)
    valid[:4] = True
    table = rng.integers(-6, N + 8, (n_tab, F)).astype(np.int32)
    ts[:4] = (I32_MIN, I32_MAX, 0, -1)
    tstab[rng.integers(0, N, 4)] = (I32_MIN, I32_MAX, 0, -1)
    return sid, ts, valid, table, tstab


DISPATCH = [(64, 4, 16, 64, False), (256, 16, 64, 256, False),
            (64, 4, 16, 64, True), (256, 16, 64, 256, True),
            (64, 16, 33, 256, True), (300, 3, 20, 97, True)]


@pytest.mark.parametrize("S,L,C,M", [(1, 64, 4, 100), (2, 300, 4, 512),
                                     (4, 97, 3, 200), (4, 33, 1, 132)])
def test_by_sid_snapshot_matches_repro(S, L, C, M):
    """The sharded round's by-sid snapshot (plain version, one call for
    values and timestamps) against ``repro``'s expression,
    ``vals_all.reshape(S L, C)[sid_to_flat]`` and
    ``ts_all.reshape(S L)[sid_to_flat]``, on ids in range (where XLA's
    clamping and the port's zero rows agree); -0.0, subnormals, NaN
    payloads and infinities keep their bits."""
    rng = np.random.default_rng(S * L + C)
    vals = rng.standard_normal((S, L, C)).astype(np.float32)
    vals.reshape(-1)[rng.integers(0, vals.size, 7)] = np.array(
        [0x80000000, 0x00000001, 0x807fffff, 0x7fc12345, 0xffa00001,
         0x7f800000, 0xff800000], np.uint32).view(np.float32)
    ts = rng.integers(I32_MIN, I32_MAX, (S, L)).astype(np.int32)
    ids = rng.integers(0, S * L, M).astype(np.int32)
    got_v, got_t = by_sid_snapshot(list(_t(vals)), list(_t(ts)), _t(ids))
    want_v = jnp.asarray(vals).reshape(S * L, C)[jnp.asarray(ids)]
    want_t = jnp.asarray(ts).reshape(S * L)[jnp.asarray(ids)]
    assert got_v.dtype == torch.float32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    np.testing.assert_array_equal(_bits(got_t), _bits(want_t))


def test_by_sid_snapshot_plain_reads_zeros_out_of_range():
    """Ids outside [0, S L) read a zero row and a zero timestamp, as the
    kernel does; the wrapper asks for the card to run the kernel, and the
    kernel's word width follows the row width and the planes' addresses."""
    vals = [torch.full((3, 2), -1.5), torch.full((3, 2), 2.5)]
    ts = [torch.tensor([7, 8, 9], dtype=torch.int32),
          torch.tensor([-4, -5, -6], dtype=torch.int32)]
    ids = torch.tensor([-1, 0, 5, 6, 3], dtype=torch.int32)
    v, t = by_sid_snapshot(vals, ts, ids)
    assert v.tolist() == [[0.0, 0.0], [-1.5, -1.5], [2.5, 2.5], [0.0, 0.0],
                          [2.5, 2.5]]
    assert t.tolist() == [0, 7, -6, 0, -4]
    with pytest.raises(ValueError, match="CUDA"):
        by_sid_snapshot(vals, ts, ids, use_kernel=True)
    assert word_lanes(4, [0, 4096]) == 4
    assert word_lanes(4, [0, 8]) == 2 and word_lanes(6, [16]) == 2
    assert word_lanes(4, [4]) == 1 and word_lanes(3, [0]) == 1


@pytest.mark.parametrize("n_tab,F,B,N,adv", DISPATCH)
@pytest.mark.parametrize("with_early", [True, False])
def test_stream_dispatch_equals_pallas_op(n_tab, F, B, N, adv, with_early):
    """The op, not the JAX ref: valid events with out-of-range sids have
    no targets, targets past the timestamps compare against 0; the
    out-table and the timestamps may differ in length (the sharded
    round's shard out-table against the global timestamps)."""
    rng = np.random.default_rng(n_tab + F + B + N + adv)
    case = _dispatch_case(rng, B, F, n_tab, N, adv)
    tj, ej = j_stream_dispatch(*map(jnp.asarray, case), interpret=True,
                               with_early=with_early)
    tp, ep = stream_dispatch(*map(_t, case), with_early=with_early)
    assert tp.dtype == torch.int32 and tp.shape == (B, F)
    np.testing.assert_array_equal(_bits(tp), np.asarray(tj))
    if with_early:
        assert ep.dtype == torch.bool
        np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))
    else:
        assert ep is None and ej is None


@pytest.mark.parametrize("with_early", [True, False])
def test_fanout_reference_matches_repro(with_early):
    """Same signature and early mask as ``repro``'s, on in-range and
    out-of-range sids and targets (both clamp)."""
    rng = np.random.default_rng(11)
    case = _dispatch_case(rng, 40, 6, 50, 70, True)
    tj, ej = j_fanout(*map(jnp.asarray, case), with_early=with_early)
    tp, ep = fanout_reference(*map(_t, case), with_early=with_early)
    np.testing.assert_array_equal(_bits(tp), np.asarray(tj))
    if with_early:
        np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))
    else:
        assert ep is None and ej is None
    # the dispatch op and the reference agree on the engine's inputs
    case = _dispatch_case(rng, 40, 6, 50, 70, False)
    tr, er = fanout_reference(*map(_t, case), with_early=with_early)
    td, ed = make_fanout()(*map(_t, case), with_early=with_early)
    np.testing.assert_array_equal(tr.numpy(), td.numpy())
    if with_early:
        np.testing.assert_array_equal(er.numpy(), ed.numpy())


# ----------------------------------------------------------------- engine
def _registry(mod, cfg, seed, n_nodes=20, n_sources=8):
    """A random multi-tenant DAG (fan-in up to max_in, fan-out capped at
    max_out) with post-filters on some composites."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry(cfg)
    tenants = [reg.create_tenant(f"t{i}") for i in range(3)]
    nodes, outs = [], []
    for v in range(n_nodes):
        ten = tenants[int(rng.integers(3))]
        if v < n_sources:
            nodes.append(reg.create_stream(ten, f"s{v}", ["v"]))
            outs.append(0)
            continue
        k = int(rng.integers(1, min(cfg.max_in, v) + 1))
        ins = [u for u in sorted(rng.choice(v, k, replace=False).tolist())
               if outs[u] < cfg.max_out] or [v - 1]
        for u in ins:
            outs[u] += 1
        expr = " + ".join(f"in{j}.v" for j in range(len(ins)))
        kw = {"post_filter": "out.v < 1e6"} if rng.random() < 0.3 else {}
        nodes.append(reg.create_composite(
            ten, f"c{v}", ["v"], [nodes[u] for u in ins],
            transform={"v": expr + " + 1"}, **kw))
        outs.append(0)
    return reg, nodes[:n_sources]


def _leaves(eng):
    out = {f"stats/{k}": _bits(v) for k, v in eng.state.stats.items()}
    for f in eng.state._fields:
        if f != "stats":
            out[f"state/{f}"] = _bits(getattr(eng.state, f))
    for i, lt in enumerate(eng.dead_letters(clear=False)):
        out[f"dlq{i}"] = np.asarray([lt.sid, lt.ts, lt.tenant, lt.its,
                                     P.DLQ_REASONS.index(lt.reason)])
        out[f"dlq{i}/vals"] = _bits(np.asarray(lt.vals, np.float32))
    return out


def _assert_same(a, b, where, sinks):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys(), where
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{where} {k}")
    assert len(sinks[0]) == len(sinks[1])
    for r, (x, y) in enumerate(zip(*sinks)):
        for f in x._fields:
            np.testing.assert_array_equal(_bits(getattr(x, f)),
                                          _bits(getattr(y, f)),
                                          err_msg=f"{where} sink {r} {f}")


def _cfg(mod, **kw):
    return mod.EngineConfig(n_streams=24, n_tenants=4, batch=8, queue=64,
                            max_in=4, max_out=4, prog_len=24, n_temps=12,
                            exchange_slots=3, dlq_slots=24,
                            retention_slots=2, **kw)


ENGINES = [(1, False), (2, True), (2, False)]


@pytest.mark.parametrize("D,fused", ENGINES,
                         ids=[f"D{d}-{'fused' if f else 'staged'}"
                              for d, f in ENGINES])
def test_dispatch_engine_equals_repro(D, fused):
    """Five rounds, then a superstep of K = 3 with same-stream bursts
    longer than K, both engines fed alike; bitwise after each."""
    kw = dict(n_shards=D, fused_round=fused)
    reg_j = _registry(J, _cfg(J, **kw), 2)[0]
    ej = (JSharded(reg_j, fanout_fn=j_make_fanout(interpret=True)) if D > 1
          else J.StreamEngine(reg_j, fanout_fn=j_make_fanout(interpret=True)))
    reg_p, srcs = _registry(P, _cfg(P, **kw), 2)
    ep = P.create_engine(reg_p, device="cpu", fanout_fn=make_fanout())
    assert ej._path == ep._path == ("fused" if fused else "staged")
    rng = np.random.default_rng(D + fused)
    for r in range(5):
        for i in rng.choice(len(srcs), 5, replace=False):
            v, t = [float(rng.integers(-9, 9))], r * 3 + int(i) % 2
            ej.post(srcs[i].sid, v, t)
            ep.post(srcs[i].sid, v, t)
        _assert_same(ej, ep, f"round {r}", ([ej.round()], [ep.round()]))
    for i in range(10):
        sid, t = srcs[i % 3].sid, 100 + i
        ej.post(sid, [float(i)], t)
        ep.post(sid, [float(i)], t)
    _assert_same(ej, ep, "superstep", (ej.spool_sinks(ej.superstep(3)),
                                       ep.spool_sinks(ep.superstep(3))))
    c = ep.counters()
    assert c["emitted"] > 0 and c == ej.counters()


@pytest.mark.parametrize("D,fused,calls", [(1, True, 0), (1, False, 1),
                                           (2, True, 2), (2, False, 2)])
def test_fanout_fn_runs_where_the_reference_runs_it(D, fused, calls):
    """The staged round calls ``fanout_fn`` once, the sharded round once
    per shard on both paths, the fused single-device round never (its
    fused stages fan out themselves); with ``with_early=False`` each
    time, and in supersteps as in rounds."""
    seen = []
    inner = make_fanout()

    def spy(*a, with_early=True):
        seen.append(with_early)
        return inner(*a, with_early=with_early)

    reg, srcs = _registry(P, _cfg(P, n_shards=D, fused_round=fused), 3)
    eng = P.create_engine(reg, device="cpu", fanout_fn=spy)
    for s in srcs[:3]:
        eng.post(s, [1.0], 1)
    eng.round()
    assert seen == [False] * calls
    eng.post(srcs[0], [2.0], 2)
    eng.spool_sinks(eng.superstep(2))
    assert seen == [False] * (3 * calls)
