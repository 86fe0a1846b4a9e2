"""The port's admission plane against the JAX package's, bitwise.

Live churn — streams, composites and subscription edges admitted and
revoked on a running engine, a program swapped — is driven through
``repro`` and the port in lockstep (``tests/test_admission.py``'s churn
script) at 1 and 2 shards.  After every phase every state leaf, every
stat, every sink and every dead letter agree bitwise, and the churned
port equals a static build of the final topology.  Every edit writes in
place: no table or state tensor of the port is reallocated (its
``data_ptr()`` does not move).  Plus the edge cases: full-table
rejection counted, revoke then readmit of the same sid, ``swap_program``
against a rebuilt registry, quarantine, and the planes that wait."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.distributed.stream_sharding import \
    ShardedStreamEngine as JSharded  # noqa: E402
from repro_torch.distributed.stream_sharding import \
    ShardedStreamEngine as PSharded  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _cfg(mod, **kw):
    base = dict(n_streams=16, n_tenants=4, batch=32, queue=128, max_in=4,
                max_out=4, prog_len=24, n_temps=12, dlq_slots=16,
                retention_slots=2)
    base.update(kw)
    return mod.EngineConfig(**base)


def _engine(mod, reg):
    """``repro``'s engine or the port's (on the CPU); sharded when the
    config asks for shards."""
    return mod.create_engine(reg, **({"device": "cpu"} if mod is P else {}))


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    a = _host(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _leaves(eng):
    out = {}
    for f in eng.state._fields:
        if f == "stats":
            for k, v in eng.state.stats.items():
                out[f"stats/{k}"] = _bits(v)
        else:
            out[f"state/{f}"] = _bits(getattr(eng.state, f))
    for f in eng.tables._fields:
        out[f"tables/{f}"] = _bits(getattr(eng.tables, f))
    for i, lt in enumerate(eng.dead_letters(clear=False)):
        out[f"dlq{i}"] = np.asarray([lt.sid, lt.ts, lt.tenant, lt.its,
                                     P.DLQ_REASONS.index(lt.reason)])
        out[f"dlq{i}/vals"] = _bits(np.asarray(lt.vals, np.float32))
    return out


def assert_same(ej, ep, where, sinks=((), ())):
    a, b = _leaves(ej), _leaves(ep)
    assert a.keys() == b.keys(), where
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, \
            f"{where} {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
    assert len(sinks[0]) == len(sinks[1]), where
    for r, (sj, sp) in enumerate(zip(*sinks)):
        for f in sj._fields:
            np.testing.assert_array_equal(_bits(getattr(sj, f)),
                                          _bits(getattr(sp, f)),
                                          err_msg=f"{where} sink {r} {f}")


def _ptrs(eng):
    """Every table, state and lookup-map tensor's storage address, and
    that of the program table the round reads (cut to the step bound)."""
    out = {f"tables/{f}": getattr(eng.tables, f).data_ptr()
           for f in eng.tables._fields}
    out["run/progs"] = eng._run_tables.progs.data_ptr()
    for f in eng.state._fields:
        if f == "stats":
            out.update({f"stats/{k}": v.data_ptr()
                        for k, v in eng.state.stats.items()})
        else:
            out[f"state/{f}"] = getattr(eng.state, f).data_ptr()
    if hasattr(eng, "gmap"):
        out.update({f"gmap/{f}": getattr(eng.gmap, f).data_ptr()
                    for f in eng.gmap._fields})
    return out


class Both:
    """Apply every call to ``repro``'s engine and the port's, checking
    that the port's call moves no tensor's storage."""

    def __init__(self, ej, ep):
        self.ej, self.ep = ej, ep

    def __call__(self, name, *args_j, args_p=None, **kw):
        before = _ptrs(self.ep)
        rj = getattr(self.ej, name)(*args_j, **kw)
        rp = getattr(self.ep, name)(*(args_j if args_p is None else args_p),
                                    **kw)
        assert _ptrs(self.ep) == before, f"{name} reallocated a tensor"
        return rj, rp


def _grow(make_stream, make_comp):
    """``tests/test_admission.py``'s multi-hop topology; creation order
    fixes the sid layout."""
    srcs = [make_stream(f"s{i}") for i in range(4)]
    comps = [
        make_comp("c0", [srcs[0]], "in0.v + 1", None),
        make_comp("c1", [srcs[0], srcs[1]], "in0.v + in1.v * 2", None),
        make_comp("c2", [srcs[2]], "in0.v * 3", "out.v < 1e6"),
    ]
    comps.append(make_comp("c3", [comps[0], comps[1]], "in0.v - in1.v", None))
    comps.append(make_comp("c4", [comps[3], srcs[3]], "in0.v + in1.v", None))
    return srcs, comps


def _schedule(srcs, waves=3):
    sched, ts = [], 1
    for w in range(waves):
        wave = [(srcs[i], [float(10 * w + i)], ts) for i in range(len(srcs))]
        wave.append((srcs[0], [float(w)], ts + 1))
        wave.append((srcs[1], [float(w)], ts + 1))
        sched.append(wave)
        ts += 3
    return sched


def _run(eng, sched):
    sinks = []
    for wave in sched:
        for stream, vals, ts in wave:
            eng.post(stream.sid, vals, ts)
        sinks += eng.drain(max_rounds=64)
    return sinks


@pytest.mark.parametrize("n_shards", [1, 2])
def test_live_churn_bitwise_in_place(n_shards):
    """The churn script on both packages in lockstep: bitwise after every
    phase, no tensor reallocated by any edit, and the churned port equal
    to a static build of the final topology (values, timestamps,
    counters)."""
    engines, tenants, seeds = [], [], []
    for mod in (J, P):
        reg = mod.Registry.with_capacity(_cfg(mod, n_shards=n_shards))
        t = reg.create_tenant("t")
        seeds.append([reg.create_stream(t, "s0", ["v"]),
                      reg.create_stream(t, "s1", ["v"])])
        engines.append(_engine(mod, reg))
        tenants.append(t)
    ej, ep = engines
    if n_shards > 1:
        assert isinstance(ep, PSharded) and isinstance(ej, JSharded)
    both = Both(ej, ep)
    assert_same(ej, ep, "built", (ej.drain(max_rounds=2),
                                  ep.drain(max_rounds=2)))

    # the warm-up edits of the JAX test: admit, subscribe, unsubscribe,
    # swap, revoke
    (tj, tp), (sj, sp) = tenants, seeds
    wj, wp = both("admit_composite", tj, "warm", ["v"], [sj[0]],
                  {"v": "in0.v"}, args_p=(tp, "warm", ["v"], [sp[0]],
                                          {"v": "in0.v"}))
    assert wj.sid == wp.sid
    both("admit_subscription", wj, sj[1], args_p=(wp, sp[1]))
    both("revoke_subscription", wj, sj[1], args_p=(wp, sp[1]))
    both("swap_program", wj, {"v": "in0.v + 1"}, args_p=(wp,
                                                        {"v": "in0.v + 1"}))
    both("revoke_stream", wj, args_p=(wp,))
    assert_same(ej, ep, "warm churn")

    made = {}

    def grow(mod_i):
        e, t = engines[mod_i], tenants[mod_i]
        pool = list(seeds[mod_i])

        def mk(n):
            if pool:
                return pool.pop(0)
            return both_step(mod_i, "admit_stream", t, n, ["v"])

        def mc(n, ins, tr, pf):
            return both_step(mod_i, "admit_composite", t, n, ["v"], ins,
                             {"v": tr}, post_filter=pf)
        return _grow(mk, mc)

    def both_step(mod_i, name, *a, **kw):
        e = engines[mod_i]
        before = _ptrs(e) if mod_i == 1 else None
        out = getattr(e, name)(*a, **kw)
        if before is not None:
            assert _ptrs(e) == before, f"{name} reallocated a tensor"
        return out

    made[0], made[1] = grow(0), grow(1)
    (srcs_j, comps_j), (srcs_p, comps_p) = made[0], made[1]
    assert [s.sid for s in srcs_j + comps_j] == \
        [s.sid for s in srcs_p + comps_p]
    both("admit_subscription", comps_j[2], srcs_j[3],
         args_p=(comps_p[2], srcs_p[3]))
    assert_same(ej, ep, "grown")
    assert_same(ej, ep, "first schedule", (_run(ej, _schedule(srcs_j)),
                                           _run(ep, _schedule(srcs_p))))
    # quarantine edits ride the same plane
    both("quarantine", comps_j[1], args_p=(comps_p[1],))
    assert ep.is_quarantined(comps_p[1])
    both("unquarantine", comps_j[1], args_p=(comps_p[1],))
    assert_same(ej, ep, "second schedule",
                (_run(ej, _schedule(srcs_j, waves=2)),
                 _run(ep, _schedule(srcs_p, waves=2))))
    assert ep.counters()["emitted"] > 0

    # static reference: same creation order, same final topology
    reg = P.Registry.with_capacity(_cfg(P, n_shards=n_shards))
    t = reg.create_tenant("t")
    srcs, comps = _grow(lambda n: reg.create_stream(t, n, ["v"]),
                        lambda n, ins, tr, pf: reg.create_composite(
                            t, n, ["v"], ins, {"v": tr}, post_filter=pf))
    reg.subscribe(comps[2], srcs[3])
    es = _engine(P, reg)
    es.drain(max_rounds=2)
    _run(es, _schedule(srcs))
    _run(es, _schedule(srcs, waves=2))
    for sid in range(16):
        np.testing.assert_array_equal(_bits(es.value_of(sid)),
                                      _bits(ep.value_of(sid)))
        assert es.ts_of(sid) == ep.ts_of(sid)
    ce, cp = es.counters(), ep.counters()
    for k in ("emitted", "processed", "discarded_stale", "coalesced",
              "filtered", "ingested"):
        assert ce[k] == cp[k], k


def test_admit_full_table_rejected_counted():
    """Capacity rejections return None/False, are counted, and leave the
    engine running — bitwise with ``repro`` after the rejections."""
    engines = []
    for mod in (J, P):
        reg = mod.Registry(_cfg(mod, n_streams=4, max_in=2))
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        for i in range(3):
            reg.create_stream(t, f"p{i}", ["v"])
        e = _engine(mod, reg)
        assert e.admit_stream(t, "overflow", ["v"]) is None
        assert e.admit_composite(t, "oc", ["v"], [a], {"v": "in0.v"}) is None
        assert e.admission_rejected == 2
        reg2 = mod.Registry.with_capacity(_cfg(mod, max_in=1), max_streams=8)
        t2 = reg2.create_tenant("t")
        x = reg2.create_stream(t2, "x", ["v"])
        y = reg2.create_stream(t2, "y", ["v"])
        c = reg2.create_composite(t2, "c", ["v"], [x], {"v": "in0.v"})
        e2 = _engine(mod, reg2)
        assert not e2.admit_subscription(c, y)
        assert e2.admission_rejected == 1
        e2.post(x.sid, [2.0], 1)
        e2.drain()
        assert e2.value_of(c)[0] == 2.0
        engines.append(e2)
    assert_same(*engines, "after rejections")


@pytest.mark.parametrize("n_shards", [1, 2])
def test_revoke_then_readmit_same_sid(n_shards):
    """A queued emission of a revoked stream is purged (counted and
    dead-lettered), the readmission recycles the sid with a fresh state,
    and the rewired pipeline runs — bitwise with ``repro`` at every
    step."""
    engines, handles = [], []
    for mod in (J, P):
        reg = mod.Registry.with_capacity(_cfg(mod, n_shards=n_shards))
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        engines.append(_engine(mod, reg))
        handles.append((t, a))
    ej, ep = engines
    both = Both(ej, ep)
    (tj, aj), (tp, ap) = handles
    cj, cp = both("admit_composite", tj, "c", ["v"], [aj],
                  {"v": "in0.v + 1"}, args_p=(tp, "c", ["v"], [ap],
                                              {"v": "in0.v + 1"}))
    for e, a in ((ej, aj), (ep, ap)):
        e.post(a.sid, [7.0], 5)
    assert_same(ej, ep, "first drain", (ej.drain(), ep.drain()))
    dj, dp = both("admit_composite", tj, "d", ["v"], [cj],
                  {"v": "in0.v * 2"}, args_p=(tp, "d", ["v"], [cp],
                                              {"v": "in0.v * 2"}))
    for e, a in ((ej, aj), (ep, ap)):
        e.post(a.sid, [9.0], 6)
    assert_same(ej, ep, "hop 1", ([ej.round()], [ep.round()]))
    old = cp.sid
    both("revoke_stream", cj, args_p=(cp,))
    assert_same(ej, ep, "revoked", (ej.drain(), ep.drain()))
    assert ep.counters()["dropped_revoked"] >= 1
    assert any(lt.reason == "revoked" for lt in ep.dead_letters(clear=False))
    assert ep.ts_of(dp) == P.engine.INT_MIN
    c2j, c2p = both("admit_stream", tj, "c2", ["v"],
                    args_p=(tp, "c2", ["v"]))
    assert c2p.sid == old == c2j.sid
    assert ep.ts_of(c2p) == P.engine.INT_MIN and ep.value_of(c2p)[0] == 0.0
    both("admit_subscription", dj, c2j, args_p=(dp, c2p))
    for e, c in ((ej, c2j), (ep, c2p)):
        e.post(c.sid, [1.0], 1)
    assert_same(ej, ep, "readmitted", (ej.drain(), ep.drain()))
    assert ep.value_of(dp)[0] == 2.0


def test_swap_program_equivalence_vs_rebuilt_registry():
    """``swap_program`` between rounds == a registry rebuilt with the new
    code (the swapped pipeline idle before the swap), on the port; and
    the swapped port equals the swapped ``repro`` bitwise."""
    def build(mod, transform_q):
        reg = mod.Registry.with_capacity(_cfg(mod))
        t = reg.create_tenant("t")
        p = reg.create_stream(t, "p", ["v"])
        q = reg.create_stream(t, "q", ["v"])
        reg.create_composite(t, "pc", ["v"], [p], {"v": "in0.v + 1"})
        qc = reg.create_composite(t, "qc", ["v"], [q], {"v": transform_q})
        return _engine(mod, reg), p, q, qc

    def run(e, p, q, qc, swap):
        e.post(p.sid, [3.0], 1)
        e.drain()
        if swap:
            port = isinstance(e, P.StreamEngine)
            before = _ptrs(e) if port else None
            e.swap_program(qc, {"v": "in0.v * 100"})
            assert not port or _ptrs(e) == before
        e.post(p.sid, [4.0], 2)
        e.post(q.sid, [5.0], 2)
        e.drain()
        return e

    ea = run(*build(P, "in0.v * 2"), swap=True)
    eb = run(*build(P, "in0.v * 100"), swap=False)
    ej = run(*build(J, "in0.v * 2"), swap=True)
    assert_same(ej, ea, "swapped")
    for sid in range(16):
        np.testing.assert_array_equal(_bits(ea.value_of(sid)),
                                      _bits(eb.value_of(sid)))
        assert ea.ts_of(sid) == eb.ts_of(sid)
    assert ea.counters() == eb.counters()
    assert ea.value_of(3)[0] == 500.0


def test_planes_that_wait_raise():
    """Replay on subscription and redelivery raised until the durability
    plane was ported: a subscription with ``replay=True`` re-enqueues the
    new input's retained history (the newest ``retention_slots`` SUs) in
    place, and the continuation equals ``repro``'s; ``redeliver()`` of an
    empty spool submits nothing."""
    engines = []
    for mod in (J, P):
        reg = mod.Registry.with_capacity(_cfg(mod))
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        c = reg.create_composite(t, "c", ["v"], [a], {"v": "in0.v"})
        b = reg.create_stream(t, "b", ["v"])
        e = _engine(mod, reg)
        e.post(a, [5.0], ts=1)
        for i in range(3):
            e.post(b, [float(i)], ts=i + 1)
        e.drain()
        before = _ptrs(e) if mod is P else None
        assert e.admit_subscription(c, b, replay=True)
        if mod is P:
            assert _ptrs(e) == before
            assert sorted(e.state.q_ts[e.state.q_valid].tolist()) == [2, 3]
        assert e.counters()["replayed"] == 2
        e.drain()
        assert e.redeliver() == 0
        engines.append(e)
    assert_same(*engines, "replayed")


def test_rewire_after_registry_edits_in_place():
    """``rewire()`` re-lowers the registry after ``Registry.subscribe``
    and a new stream into the existing tables (in place) and keeps the
    QoS knobs; the continuation equals ``repro``'s bitwise."""
    engines, handles = [], []
    for mod in (J, P):
        reg = mod.Registry.with_capacity(_cfg(mod))
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        c = reg.create_composite(t, "c", ["v"], [a], {"v": "in0.v * 3"})
        e = _engine(mod, reg)
        e.set_weight(t, 5)
        e.post(a.sid, [2.0], 1)
        e.drain()
        b = reg.create_stream(t, "b", ["v"])
        reg.subscribe(c, b)
        engines.append(e)
        handles.append((a, b, c))
    ej, ep = engines
    before = _ptrs(ep)
    ej.rewire()
    ep.rewire()
    assert _ptrs(ep) == before
    assert int(ep.tables.weight[0]) == 5
    for e, (a, b, c) in zip(engines, handles):
        e.inject_code(c, {"v": "in0.v * 3 + in1.v"})
        e.post(b.sid, [10.0], 2)
    assert_same(ej, ep, "rewired", (ej.drain(), ep.drain()))
    assert ep.value_of(handles[1][2])[0] == 16.0


@pytest.mark.parametrize("n_shards", [1, 2])
def test_program_cut_keeps_its_storage(n_shards):
    """The round reads ``tables.progs`` cut to the VM's step bound.  The
    cut keeps its storage through every program edit; its shape grows
    (and ``_sync_admitted`` runs) only when an edit needs more steps than
    any program before it, and a shorter program leaves it as it is."""
    reg = P.Registry.with_capacity(_cfg(P, n_shards=n_shards))
    t = reg.create_tenant("t")
    a = reg.create_stream(t, "a", ["v"])
    c = reg.create_composite(t, "c", ["v"], [a], {"v": "in0.v + 1"})
    e = _engine(P, reg)
    synced = []
    e._sync_admitted = lambda: synced.append(e._run_tables.progs.shape)
    ptr, steps = e._run_tables.progs.data_ptr(), \
        e._run_tables.progs.shape[-2]
    long = {"v": "max(in0.v * 2 + 3, in0.v - 4) * 0.5 + abs(in0.v)"}
    for transform, grows in ((long, True), ({"v": "in0.v"}, False),
                             (long, False)):
        before = len(synced)
        e.swap_program(c, transform)
        cut = e._run_tables.progs
        assert cut.data_ptr() == ptr
        assert (cut.shape[-2] > steps) == grows
        assert len(synced) - before == grows
        torch.testing.assert_close(
            cut, e.tables.progs[..., :cut.shape[-2], :], rtol=0, atol=0)
        assert not bool((e.tables.progs[..., cut.shape[-2]:, 0] != 0).any())
        steps = cut.shape[-2]
    assert len(synced) == 1
    e.post(a, [2.0], 1)
    e.drain()
    assert float(e.value_of(c)[0]) == 5.5
