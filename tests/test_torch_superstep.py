"""The port's superstep plane against the JAX package's and against its own
rounds, bitwise.

A K-round ``superstep()`` of the port must equal ``repro``'s superstep on
the same posts (every state leaf, every stat, the spool, the per-round
sinks rebuilt from it, the latency records and the host backlog), and
equal K sequential ``round()`` calls of the port itself.  Covered on both
round paths: K in {1, 3, 64} on ``tests/test_superstep.py``'s topology
(same-stream bursts longer than K ride the ring's carried overflow),
supersteps mixed with single rounds and a change of K, spool overflow
(counted and dead-lettered), ``drain()`` riding supersteps, and the
contract that the K rounds read nothing back to the host."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

PATHS = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "staged"])


def _create(mod, reg):
    return mod.create_engine(reg, **({"device": "cpu"} if mod is P else {}))


def _cfg(mod, **kw):
    base = dict(n_streams=16, n_tenants=4, batch=8, queue=64, max_in=4,
                max_out=4, prog_len=24, n_temps=12, dlq_slots=8)
    base.update(kw)
    return mod.EngineConfig(**base)


def _build(mod, **kw):
    """tests/test_superstep.py's topology: multi-hop with fan-out,
    fan-in and a post-filter."""
    reg = mod.Registry.with_capacity(_cfg(mod, **kw))
    t = reg.create_tenant("t")
    srcs = [reg.create_stream(t, f"s{i}", ["v"]) for i in range(4)]
    comps = [
        reg.create_composite(t, "c0", ["v"], [srcs[0]], {"v": "in0.v + 1"}),
        reg.create_composite(t, "c1", ["v"], [srcs[0], srcs[1]],
                             {"v": "in0.v + in1.v * 2"}),
        reg.create_composite(t, "c2", ["v"], [srcs[2]], {"v": "in0.v * 3"},
                             post_filter="out.v < 1e6"),
    ]
    comps.append(reg.create_composite(t, "c3", ["v"], [comps[0], comps[1]],
                                      {"v": "in0.v - in1.v"}))
    comps.append(reg.create_composite(t, "c4", ["v"], [comps[3], srcs[3]],
                                      {"v": "in0.v + in1.v"}))
    return _create(mod, reg), srcs


def _post_schedule(engines, srcs, waves=3, ts0=1):
    """Waves, same-ts ties and same-stream bursts of five."""
    ts = ts0
    for w in range(waves):
        for e in engines:
            for i, s in enumerate(srcs):
                e.post(s.sid, [float(10 * w + i)], ts)
            e.post(srcs[0].sid, [float(w)], ts + 1)
            e.post(srcs[1].sid, [float(w)], ts + 1)
            for b in range(5):
                e.post(srcs[2].sid, [float(100 * w + b)], ts + 2 + b)
        ts += 8


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    a = _host(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(x, y, what):
    x, y = _bits(x), _bits(y)
    assert x.shape == y.shape, what
    np.testing.assert_array_equal(x, y, err_msg=what)


def _assert_state(ea, eb, what=""):
    for f in J.EngineState._fields:
        if f == "stats":
            assert ea.state.stats.keys() == eb.state.stats.keys()
            for k in ea.state.stats:
                _eq(ea.state.stats[k], eb.state.stats[k], f"{what} stat {k}")
        else:
            _eq(getattr(ea.state, f), getattr(eb.state, f), f"{what} {f}")
    assert [(e[0], e[2], e[4]) for e in ea._pending] == \
        [(e[0], e[2], e[4]) for e in eb._pending], what
    for x, y in zip(ea._pending, eb._pending):
        _eq(x[1], y[1], f"{what} pending payload")
    assert ea._rounds_done == eb._rounds_done


def _assert_sinks(sa, sb, what=""):
    assert len(sa) == len(sb), what
    for k, (a, b) in enumerate(zip(sa, sb)):
        for f in a._fields:
            _eq(getattr(a, f), getattr(b, f), f"{what} sink {k} {f}")


def _assert_records(ra, rb, what=""):
    assert ra.keys() == rb.keys()
    for k in ra:
        _eq(ra[k], rb[k], f"{what} records {k}")


def _assert_superstep(ej, ep, sj, sp, what):
    """One superstep of each package: spool, sinks, records and state."""
    for f in J.SinkSpool._fields:
        _eq(getattr(sj, f), getattr(sp, f), f"{what} spool {f}")
    _assert_sinks(ej.spool_sinks(sj), ep.spool_sinks(sp), what)
    _assert_records(ej.latency_records(sj), ep.latency_records(sp), what)
    _assert_state(ej, ep, what)
    assert ej._last_base == ep._last_base


@PATHS
@pytest.mark.parametrize("K", [1, 3, 64])
def test_superstep_equals_jax_and_own_rounds(fused, K):
    ej, sj = _build(J, fused_round=fused)
    ep, sp = _build(P, fused_round=fused)
    er, _ = _build(P, fused_round=fused)
    assert ep._path == ej._path == ("fused" if fused else "staged")
    _post_schedule([ej, ep, er], sp)
    spool_j, spool_p = ej.superstep(K), ep.superstep(K)
    _assert_superstep(ej, ep, spool_j, spool_p, f"K={K}")
    rounds = [er.round() for _ in range(K)]
    _assert_sinks([s._replace(**{f: _host(getattr(s, f))
                                 for f in s._fields}) for s in rounds],
                  ep.spool_sinks(spool_p), "rounds")
    _assert_state(er, ep, "rounds")
    assert ep.counters() == er.counters() == ej.counters()
    assert ep.counters()["emitted"] > 0
    if K == 3:      # bursts longer than K stayed behind, resident or not
        assert ep._pending and any(e[3] is not None for e in ep._pending)


@PATHS
def test_superstep_sequence_with_rounds_and_new_k(fused):
    """Supersteps carried across boundaries (overflow re-tagged, spilled
    and re-shipped), single rounds in between (their ring slots freed),
    and a change of K (a fresh ring): bitwise with ``repro`` throughout."""
    ej, sj = _build(J, fused_round=fused, queue=16)
    ep, sp = _build(P, fused_round=fused, queue=16)
    _post_schedule([ej, ep], sp, waves=4)
    for step, K in enumerate((3, None, 3, 2, None, 5)):
        if K is None:
            _assert_sinks([ej.round()], [ep.round()], f"round {step}")
            _assert_state(ej, ep, f"round {step}")
            continue
        spool_j, spool_p = ej.superstep(K), ep.superstep(K)
        _assert_superstep(ej, ep, spool_j, spool_p, f"step {step} K={K}")
        if step == 2:
            _post_schedule([ej, ep], sp, waves=2, ts0=100)
    assert ep.counters() == ej.counters()


def test_sink_spool_overflow_counted_and_dead_lettered():
    """Emissions beyond ``sink_spool_slots`` count in ``dropped_spool``
    and land in the dead-letter spool; the kept prefix is exact."""
    def build(mod):
        cfg = mod.EngineConfig(n_streams=16, batch=8, queue=64, max_in=1,
                               max_out=6, sink_spool_slots=2, dlq_slots=8)
        reg = mod.Registry(cfg)
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        subs = [reg.create_composite(t, f"c{i}", ["v"], [a],
                                     {"v": "a.v + 1"}) for i in range(6)]
        eng = _create(mod, reg)
        eng.post(a, [1.0], ts=1)
        return eng, subs

    (ej, _), (ep, subs) = build(J), build(P)
    spool_j, spool_p = ej.superstep(2), ep.superstep(2)
    c = ep.counters()
    assert c["emitted"] == 6 and c["dropped_spool"] == 4
    assert int(spool_p.fill) == 2
    assert spool_p.sid[:2].tolist() == [subs[0].sid, subs[1].sid]
    assert spool_p.ts[:2].tolist() == [1, 1]
    _eq(spool_p.vals[:2, 0], np.asarray([2.0, 2.0], np.float32), "vals")
    _assert_superstep(ej, ep, spool_j, spool_p, "overflow")
    lj, lp = ej.dead_letters(), ep.dead_letters()
    assert [(x.sid, x.ts, x.reason, x.tenant, x.its) for x in lj] == \
        [(x.sid, x.ts, x.reason, x.tenant, x.its) for x in lp]
    assert [x.reason for x in lp] == ["spool"] * 4


def test_spool_default_capacity_never_overflows():
    ep, srcs = _build(P)
    for w in range(4):
        for s in srcs:
            ep.post(s, [float(w)], w + 1)
    ep.superstep(8)
    assert ep.counters()["dropped_spool"] == 0
    assert ep.counters()["emitted"] > 0


@PATHS
def test_drain_rides_supersteps(fused):
    """``cfg.superstep > 1`` routes ``drain()`` through supersteps: the
    same sinks and state as ``repro``'s drain, and the same final state
    and emission log as the port's per-round drain."""
    ej, sj = _build(J, fused_round=fused, superstep=4)
    ep, sp = _build(P, fused_round=fused, superstep=4)
    e1, _ = _build(P, fused_round=fused)
    _post_schedule([ej, ep, e1], sp)
    sinks_j, sinks_p, sinks_1 = ej.drain(), ep.drain(), e1.drain()
    _assert_sinks(sinks_j, sinks_p, "drain")
    _assert_state(ej, ep, "drain")
    assert not ep._pending and not bool(ep.state.q_valid.any())

    def emissions(sinks):
        out = []
        for s in sinks:
            v = _host(s.valid)
            out += list(zip(_host(s.sid)[v].tolist(), _host(s.ts)[v].tolist(),
                            _host(s.vals)[v][:, 0].tolist()))
        return out

    assert emissions(sinks_p) == emissions(sinks_1) != []
    for f in ("values", "timestamps", "tenant_emitted"):
        _eq(getattr(ep.state, f), getattr(e1.state, f), f)


class _HostReads(TorchDispatchMode):
    """Records every op that reads device data back to the host, has a
    shape that depends on the data, or makes a tensor from host data —
    each is a synchronising copy on the card."""
    SYNCING = {"aten._local_scalar_dense", "aten.nonzero",
               "aten.lift_fresh", "aten.masked_select", "aten._unique2",
               "aten.unique_consecutive", "aten.repeat_interleave.Tensor",
               "aten.repeat_interleave.self_Tensor"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        indices = args[1] if str(func.overloadpacket) in (
            "aten.index", "aten.index_put", "aten.index_put_") else ()
        if (name in self.SYNCING or str(func.overloadpacket) in self.SYNCING
                or any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in indices)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@PATHS
def test_superstep_rounds_read_nothing_back(fused):
    """The K rounds of a superstep only enqueue device work: no scalar
    readback, no data-dependent shape, no tensor made from host data
    (each would synchronise with the card).  Staging and the spool
    readback lie outside the K rounds."""
    ep, sp = _build(P, fused_round=fused)
    _post_schedule([ep], sp)
    ep._stage(5)
    with _HostReads() as spy:
        ep._run_superstep(5)
    assert spy.seen == []
    assert ep.counters()["emitted"] > 0
