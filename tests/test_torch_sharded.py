"""The port's sharded engine (shards emulated on one device) against the
JAX package's sharded engine, against itself and against its
single-device engine, bitwise.

* ``repro`` sharded == port sharded, leaf by leaf after every round and
  every superstep (every state leaf with its shard axis, every stat,
  every sink, the spools), at D in {1, 2, 4, 8} on the fused path and at
  D = 2 on the staged path, with undersized exchange buckets so that
  overflow is counted and dead-lettered on both.
* Port staged == port fused at D in {1, 4, 8} (so the staged path equals
  ``repro`` there too), superstep(K) == K rounds for K in {1, 3}, and
  sharded == single-device when ``exchange_slots=0`` and every round
  drains, under the block and the tenant partition.
* The partition (bijective, equal to ``repro``'s plan), exchange overflow
  charged to the emitting tenant, ``rebalance`` state migration against
  ``repro``, ``rewire`` remapping state, and the planes that wait."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.distributed.stream_sharding import \
    ShardedStreamEngine as JSharded  # noqa: E402
from repro.distributed.stream_sharding import \
    plan_partition as j_plan  # noqa: E402
from repro_torch.distributed.stream_sharding import (  # noqa: E402
    ShardedStreamEngine as PSharded, plan_partition)


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _sharded(mod, reg):
    """The sharded engine class of ``mod`` (also at one shard)."""
    return JSharded(reg) if mod is J else PSharded(reg, device="cpu")


def _random_registry(mod, cfg, seed, n_tenants=3, n_nodes=24, n_sources=10):
    """``tests/test_sharded_engine.py``'s random multi-tenant DAG: with a
    block partition the sid interleaving gives many cross-shard edges."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry(cfg)
    tenants = [reg.create_tenant(f"t{i}") for i in range(n_tenants)]
    nodes = []
    for v in range(n_nodes):
        ten = tenants[int(rng.integers(n_tenants))]
        if v < n_sources:
            nodes.append(reg.create_stream(ten, f"s{v}", ["v"]))
            continue
        k = int(rng.integers(1, min(cfg.max_in, v) + 1))
        ins = sorted(rng.choice(v, size=k, replace=False).tolist())
        ins = [u for u in ins
               if sum(1 for s in reg.streams
                      if s.composite and u in s.inputs) < cfg.max_out]
        if not ins:
            ins = [v - 1]
        srcs = [nodes[u] for u in ins]
        expr = " + ".join(f"in{j}.v" for j in range(len(srcs)))
        kw = {"post_filter": "out.v < 1e6"} if rng.random() < 0.3 else {}
        nodes.append(reg.create_composite(
            ten, f"c{v}", ["v"], srcs, transform={"v": expr + " + 1"}, **kw))
    return reg, [n for n in nodes if not n.composite]


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


def assert_same(a, b, where, sinks=((), ())):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys(), where
    for k in la:
        assert la[k].shape == lb[k].shape, f"{where} {k}"
        np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{where} {k}")
    assert len(sinks[0]) == len(sinks[1])
    for r, (x, y) in enumerate(zip(*sinks)):
        for f in x._fields:
            np.testing.assert_array_equal(_bits(getattr(x, f)),
                                          _bits(getattr(y, f)),
                                          err_msg=f"{where} sink {r} {f}")


def _cfg(mod, **kw):
    base = dict(n_streams=24, n_tenants=4, batch=8, queue=64, max_in=4,
                max_out=4, prog_len=24, n_temps=12, exchange_slots=3,
                dlq_slots=24, retention_slots=2)
    base.update(kw)
    return mod.EngineConfig(**base)


def _posts(rng, srcs, r, k=6):
    return [(srcs[i].sid, [float(rng.integers(-9, 9))],
             r * 3 + int(rng.integers(0, 2)))
            for i in rng.choice(len(srcs), k, replace=False)]


def _lockstep(ea, eb, srcs, seed, rounds=6, steps=((3, 12),)):
    """Posts to both engines; ``rounds`` single rounds, then one
    superstep per ``(K, n_posts)``; bitwise after each."""
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        for sid, v, t in _posts(rng, srcs, r):
            ea.post(sid, v, t)
            eb.post(sid, v, t)
        assert_same(ea, eb, f"round {r}", ([ea.round()], [eb.round()]))
    for s, (K, n) in enumerate(steps):
        for i in range(n):
            sid, t = srcs[i % len(srcs)].sid, 100 + 20 * s + i
            ea.post(sid, [float(i)], t)
            eb.post(sid, [float(i)], t)
        assert_same(ea, eb, f"superstep {s} (K={K})",
                    (ea.spool_sinks(ea.superstep(K)),
                     eb.spool_sinks(eb.superstep(K))))


PARITY = [(1, True), (2, True), (4, True), (8, True), (2, False)]


@pytest.mark.parametrize("D,fused", PARITY,
                         ids=[f"D{d}-{'fused' if f else 'staged'}"
                              for d, f in PARITY])
def test_sharded_bitwise_equal_to_jax_sharded(D, fused):
    ej = _sharded(J, _random_registry(J, _cfg(J, n_shards=D,
                                              fused_round=fused), 1)[0])
    reg, srcs = _random_registry(P, _cfg(P, n_shards=D, fused_round=fused),
                                 1)
    ep = _sharded(P, reg)
    assert ej._path == ep._path == ("fused" if fused else "staged")
    _lockstep(ej, ep, srcs, seed=3)
    c = ep.counters()
    assert c["emitted"] > 0 and c == ej.counters()
    if D in (2, 4):
        assert c["dropped_overflow"] > 0      # undersized buckets overflowed
        assert any(lt.reason == "overflow"
                   for lt in ep.dead_letters(clear=False))


@pytest.mark.parametrize("D", [1, 4, 8])
def test_port_staged_equals_port_fused(D):
    engines = []
    for fused in (True, False):
        reg, srcs = _random_registry(P, _cfg(P, n_shards=D,
                                             fused_round=fused), 2)
        engines.append(_sharded(P, reg))
    assert [e._path for e in engines] == ["fused", "staged"]
    _lockstep(*engines, srcs, seed=4)


@pytest.mark.parametrize("K", [1, 3])
def test_sharded_superstep_equals_rounds(K):
    """superstep(K) == K rounds on the port's 4-shard engine: every
    per-round sink rebuilt from the spools, every state leaf and stat,
    with same-stream bursts longer than K carried in the ring."""
    engines = []
    for _ in range(2):
        reg, srcs = _random_registry(P, _cfg(P, n_shards=4), 5)
        engines.append(_sharded(P, reg))
    es, er = engines
    rng = np.random.default_rng(6)
    for s in range(3):
        posts = _posts(rng, srcs, s, k=8) + [
            (srcs[0].sid, [float(b)], 50 + 10 * s + b) for b in range(K + 2)]
        for e in engines:
            for sid, v, t in posts:
                e.post(sid, v, t)
        assert_same(es, er, f"superstep {s}",
                    (es.spool_sinks(es.superstep(K)),
                     [er.round() for _ in range(K)]))
    assert es.counters()["emitted"] > 0


@pytest.mark.parametrize("D,partition", [(2, "block"), (4, "block"),
                                         (8, "block"), (2, "tenant"),
                                         (4, "tenant")])
def test_sharded_equals_single_device(D, partition):
    """With ``exchange_slots=0`` and a batch that drains every queue each
    round, the sharded engine processes the same work items per round as
    the single-device one: equal values, timestamps, counters and
    per-tenant emissions."""
    kw = dict(batch=48, queue=192, exchange_slots=0)
    reg1, s1 = _random_registry(P, _cfg(P, **kw), 7)
    regS, sS = _random_registry(P, _cfg(P, n_shards=D, partition=partition,
                                        **kw), 7)
    e1, eS = P.create_engine(reg1, device="cpu"), P.create_engine(
        regS, device="cpu")
    assert isinstance(eS, PSharded) and not isinstance(e1, PSharded)
    rng = np.random.default_rng(8)
    for w in range(4):
        for sid, v, t in _posts(rng, s1, w, k=8):
            e1.post(sid, v, t)
            eS.post(sid, v, t)
        e1.drain(max_rounds=64)
        eS.drain(max_rounds=64)
    for sid in range(24):
        np.testing.assert_array_equal(_bits(e1.value_of(sid)),
                                      _bits(eS.value_of(sid)))
        assert e1.ts_of(sid) == eS.ts_of(sid)
    assert e1.counters() == eS.counters()
    for k, v in e1.tenant_counters().items():
        if k != "queued":
            np.testing.assert_array_equal(v, eS.tenant_counters()[k])
    for k, v in e1.fault_counters().items():
        np.testing.assert_array_equal(v, eS.fault_counters()[k])


@pytest.mark.parametrize("partition", ["block", "tenant"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_plan_partition_is_bijective(partition, n_shards):
    cfg = P.EngineConfig(n_streams=37, n_tenants=5, n_shards=n_shards,
                         partition=partition)
    tenant = np.arange(37) % 5
    plan = plan_partition(cfg, tenant)
    assert plan.n_shards == n_shards
    assert len(np.unique(plan.sid_to_flat)) == 37
    assert (plan.sid_to_shard < n_shards).all()
    assert (plan.sid_to_local < plan.n_local).all()
    np.testing.assert_array_equal(
        plan.local_to_sid[plan.sid_to_shard, plan.sid_to_local],
        np.arange(37))
    want = j_plan(J.EngineConfig(**dataclasses.asdict(cfg)), tenant)
    for a, b in zip(plan, want):
        np.testing.assert_array_equal(a, b)


def test_exchange_overflow_counted_charged_and_dead_lettered():
    """One source on shard 0 fans out to six subscribers on shard 1;
    two exchange slots: two items cross, four are counted in
    ``dropped_overflow``, charged to the source's tenant and
    dead-lettered as ``overflow``."""
    cfg = P.EngineConfig(n_streams=16, batch=16, queue=64, max_in=1,
                         max_out=6, n_shards=2, exchange_slots=2,
                         dlq_slots=8)
    reg = P.Registry(cfg)
    t0, t1 = reg.create_tenant("src"), reg.create_tenant("subs")
    a = reg.create_stream(t0, "a", ["v"])
    for i in range(7):
        reg.create_stream(t1, f"p{i}", ["v"])
    subs = [reg.create_composite(t1, f"c{i}", ["v"], [a],
                                 transform={"v": "a.v + 1"})
            for i in range(6)]
    eng = P.create_engine(reg, device="cpu")
    assert all(eng.plan.sid_to_shard[s.sid] == 1 for s in subs)
    eng.post(a, [1.0], ts=1)
    eng.drain()
    c = eng.counters()
    assert c["dropped_overflow"] == 4 and c["emitted"] == 2
    assert sum(eng.ts_of(s) == 1 for s in subs) == 2
    assert eng.tenant_counters()["dropped_overflow"][t0.tid] == 4
    letters = eng.dead_letters()
    assert [lt.reason for lt in letters] == ["overflow"] * 4
    assert {lt.sid for lt in letters} == {a.sid}
    assert all(lt.tenant == t0.tid for lt in letters)


def test_rebalance_migrates_state_bitwise():
    """``tests/test_admission.py``'s rebalance on both packages: the
    moved rows carry their values, the pipeline keeps running across
    shards, every leaf equal to ``repro``'s, and no tensor moves."""
    engines, comps, srcs = [], [], []
    for mod in (J, P):
        reg = mod.Registry.with_capacity(_cfg(mod, n_streams=12, n_shards=2,
                                              partition="tenant",
                                              exchange_slots=0))
        t0 = reg.create_tenant("even")
        a = reg.create_stream(t0, "a", ["v"])
        e = _sharded(mod, reg)
        comps.append([e.admit_composite(t0, f"c{i}", ["v"], [a],
                                        {"v": f"in0.v + {i}"})
                      for i in range(4)])
        e.post(a, [10.0], ts=1)
        e.drain()
        engines.append(e)
        srcs.append(a)
    ej, ep = engines
    assert ep._occupancy[0] - ep._occupancy[1] >= 4
    def ptrs():
        return [t.data_ptr() for t in (*ep.tables, ep._run_tables.progs)]
    before = ptrs()
    assert ej.rebalance() == ep.rebalance() >= 2
    assert ptrs() == before
    assert ep._occupancy.max() - ep._occupancy.min() <= 1
    np.testing.assert_array_equal(ep.plan.sid_to_flat, ej.plan.sid_to_flat)
    assert [float(ep.value_of(c)[0]) for c in comps[1]] == [10, 11, 12, 13]
    assert_same(ej, ep, "rebalanced")
    for e, a in zip(engines, srcs):
        e.post(a, [20.0], ts=2)
    assert_same(ej, ep, "after", (ej.drain(), ep.drain()))
    assert [float(ep.value_of(c)[0]) for c in comps[1]] == [20, 21, 22, 23]
    ep.post(srcs[1], [1.0], ts=3)
    with pytest.raises(ValueError, match="flight|drain"):
        ep.rebalance()


def test_tenant_rewire_remaps_state():
    """Under the tenant partition a new tenant's stream moves placement;
    ``rewire()`` carries values and timestamps into the new layout and
    refuses while SUs are in flight."""
    cfg = P.EngineConfig(n_streams=12, n_tenants=4, batch=12, queue=48,
                         max_in=2, max_out=2, n_shards=2, partition="tenant")
    reg = P.Registry(cfg)
    t0, t1 = reg.create_tenant("even"), reg.create_tenant("odd")
    a = reg.create_stream(t0, "a", ["v"])
    x = reg.create_composite(t0, "x", ["v"], [a], transform={"v": "a.v * 3"})
    eng = P.create_engine(reg, device="cpu")
    eng.post(a, [2.0], ts=1)
    eng.drain()
    old = eng.plan.sid_to_flat.copy()
    b = reg.create_stream(t1, "b", ["v"])
    reg.subscribe(x, b)
    eng.post(a, [5.0], ts=5)
    with pytest.raises(ValueError, match="flight|drain"):
        eng.rewire()
    eng.drain()
    eng.rewire()
    eng.inject_code(x, {"v": "a.v * 3 + b.v"})
    assert (eng.plan.sid_to_flat != old).any()
    assert eng.value_of(x)[0] == 15.0 and eng.ts_of(a) == 5
    eng.post(b, [10.0], ts=6)
    eng.drain()
    assert eng.value_of(x)[0] == 25.0        # 5*3 + 10, cross-shard input


def test_sharded_planes_that_wait_raise():
    """The durability and elastic planes this test saw raise until they
    were ported: the sharded snapshot carries the maps and the plan,
    ``reshard_snapshot`` re-lays it out for 4 shards, and ``resize(4)``
    installs exactly that layout in place."""
    reg = P.Registry(P.EngineConfig(n_streams=8, batch=4, queue=8,
                                    n_shards=2))
    eng = P.create_engine(reg, device="cpu")
    arrays, meta = eng.snapshot()
    assert meta["kind"] == "sharded"
    assert arrays["plan/local_to_sid"].shape == (2, 4)
    assert arrays["gmap/sid_to_flat"].shape == (8,)
    from repro_torch.distributed import stream_sharding as SS
    out, meta4 = SS.reshard_snapshot(arrays, meta, 4)
    assert meta4["registry"]["cfg"]["n_shards"] == 4
    assert eng.resize(4) is eng and eng.plan.n_shards == 4
    now = eng.snapshot()[0]
    assert sorted(now) == sorted(out)
    for k in out:
        np.testing.assert_array_equal(now[k], out[k], err_msg=k)


def test_sharded_placement_and_occupancy():
    """Admissions on the block partition go to the least-loaded shard
    (spread stays <= 1; the plan and the lookup maps agree); revoking
    them restores the occupancy."""
    reg = P.Registry.with_capacity(_cfg(P, n_streams=16, n_shards=2))
    t = reg.create_tenant("t")
    reg.create_stream(t, "a", ["v"])
    eng = P.create_engine(reg, device="cpu")
    occ0 = eng._occupancy.copy()
    added = [eng.admit_stream(t, f"n{i}", ["v"]) for i in range(4)]
    assert eng._occupancy.sum() == occ0.sum() + 4
    assert eng._occupancy.max() - eng._occupancy.min() <= 1
    for name in ("sid_to_shard", "sid_to_local", "sid_to_flat"):
        np.testing.assert_array_equal(getattr(eng.gmap, name).numpy(),
                                      getattr(eng.plan, name))
    for s in added:
        assert eng.state.timestamps[eng._table_row(s.sid)] == \
            P.engine.INT_MIN and bool(eng.tables.active[eng._table_row(s.sid)])
        eng.revoke_stream(s)
    np.testing.assert_array_equal(eng._occupancy, occ0)
