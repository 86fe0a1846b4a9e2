"""The port's elastic plane against the JAX package's, bitwise.

* ``reshard_snapshot``: the port's output equals ``repro``'s (every array,
  its dtype and the meta) for 1->2, 2->4, 4->2 and 2->1 shards under the
  block and the tenant partition, on a snapshot with queued SUs, dead
  letters, retained history and a scale-in that overflows a queue.
* ``resize``: ``resize(M)`` equals ``restore_engine(snapshot(),
  n_shards=M)`` in the port, and both continue alike; the chain
  1->2->4->2->1 with traffic between hops equals ``repro``'s, and a
  return to a layout seen before reuses its round closures.
* The autoscaler on ``tests/test_elastic.py``'s burst-then-idle feed:
  the same scale events and the same final engine as ``repro``'s, and
  its bounds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.distributed.stream_sharding import \
    reshard_snapshot as j_reshard  # noqa: E402
from repro.launch.autoscale import Autoscaler as JAutoscaler  # noqa: E402
from repro_torch.distributed.stream_sharding import \
    reshard_snapshot as p_reshard  # noqa: E402
from repro_torch.launch import Autoscaler as PAutoscaler  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _cfg(mod, **kw):
    base = dict(n_streams=16, n_tenants=4, batch=8, queue=64, max_in=4,
                max_out=4, prog_len=24, n_temps=12,
                retention_slots=6, dlq_slots=16)
    base.update(kw)
    return mod.EngineConfig(**base)


def _engine(mod, reg):
    return mod.create_engine(reg, **({"device": "cpu"} if mod is P else {}))


def _build(mod, cfg, n_tenants=1):
    """``tests/test_elastic.py``'s multi-hop topology, its streams dealt
    round-robin over ``n_tenants`` tenants (so the tenant partition
    spreads them)."""
    reg = mod.Registry.with_capacity(cfg)
    ts = [reg.create_tenant(f"t{i}") for i in range(n_tenants)]
    srcs = [reg.create_stream(ts[i % n_tenants], f"s{i}", ["v"])
            for i in range(4)]
    comps = [
        reg.create_composite(ts[0], "c0", ["v"], [srcs[0]],
                             {"v": "in0.v + 1"}),
        reg.create_composite(ts[1 % n_tenants], "c1", ["v"],
                             [srcs[0], srcs[1]], {"v": "in0.v + in1.v * 2"}),
        reg.create_composite(ts[2 % n_tenants], "c2", ["v"], [srcs[2]],
                             {"v": "in0.v * 3"}, post_filter="out.v < 1e6"),
    ]
    comps.append(reg.create_composite(ts[0], "c3", ["v"],
                                      [comps[0], comps[1]],
                                      {"v": "in0.v - in1.v"}))
    return srcs, _engine(mod, reg)


def _post_wave(eng, srcs, wave, base_ts):
    for i, s in enumerate(srcs):
        eng.post(s, [float(10 * wave + i)], base_ts)
    eng.post(srcs[0], [float(wave)], base_ts + 1)
    eng.post(srcs[2], [float(100 + wave)], base_ts + 2)


def _run(eng, srcs, waves, ts, K):
    sinks = []
    for w in waves:
        _post_wave(eng, [eng.registry.streams[s.sid] for s in srcs], w, ts)
        ts += 4
        if K == 1:
            sinks.append(eng.round())
        else:
            sinks += eng.spool_sinks(eng.superstep(K), K)
    return sinks, ts


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_arrays(xa, xb, where):
    assert sorted(xa) == sorted(xb), where
    for k in xa:
        u, v = _bits(xa[k]), _bits(xb[k])
        assert u.dtype == v.dtype and u.shape == v.shape, f"{where} {k}"
        np.testing.assert_array_equal(u, v, err_msg=f"{where} {k}")


def assert_same(a, b, where):
    (xa, ma), (xb, mb) = a.snapshot(), b.snapshot()
    assert_same_arrays(xa, xb, where)
    assert ma == mb, where


def assert_same_sinks(sa, sb, where):
    assert len(sa) == len(sb), where
    for i, (x, y) in enumerate(zip(sa, sb)):
        for f, u, v in zip(x._fields, x, y):
            np.testing.assert_array_equal(_bits(u), _bits(v),
                                          err_msg=f"{where} sink {i} {f}")


# --------------------------------------------------------------------------
# reshard_snapshot
# --------------------------------------------------------------------------

@pytest.mark.parametrize("partition", ["block", "tenant"])
@pytest.mark.parametrize("n_from,n_to", [(1, 2), (2, 4), (4, 2), (2, 1)])
def test_reshard_snapshot_matches_repro(n_from, n_to, partition):
    """The same snapshot re-laid out by both packages: every array
    bitwise with its dtype, and the meta, equal.  The snapshot (from the
    port) holds a revoked stream's dead letter, retained history, a host
    backlog and queues of 16 filled by redelivering 20 letters, so that
    the 4->2 block and 2->1 tenant scale-ins overflow a queue into the
    dead letters."""
    cfg = _cfg(P, n_shards=n_from, partition=partition, queue=16, batch=2,
               superstep=2)
    srcs, eng = _build(P, cfg, n_tenants=3)
    eng.revoke_stream(srcs[3])
    eng.post(srcs[3].sid, [1.0], 1)         # dead-lettered at ingest
    _, ts = _run(eng, srcs[:3], range(3), 2, 2)
    live = [x.sid for x in eng.registry.streams if x is not None]
    eng.redeliver([P.DeadLetter(live[k % len(live)],
                                np.full(4, k, np.float32), 100 + k,
                                "overflow", 0, k) for k in range(20)])
    _post_wave(eng, srcs[:3], 9, ts)
    arrays, meta = eng.snapshot()
    assert int(eng.state.q_valid.sum()) > 0 and eng._pending
    assert eng.dead_letters(clear=False)
    got = p_reshard(arrays, meta, n_to, partition=partition)
    want = j_reshard(arrays, meta, n_to, partition=partition)
    assert_same_arrays(got[0], want[0], f"{n_from}->{n_to}")
    over = [x["state/stats/dropped_overflow"].sum() for x in (arrays, got[0])]
    if (n_from, n_to, partition) in ((4, 2, "block"), (2, 1, "tenant")):
        assert over[1] > over[0]
    assert got[1] == want[1]
    assert got[1]["kind"] == ("sharded" if n_to > 1 else "single")
    assert_same_arrays(arrays, eng.snapshot()[0], "input unchanged")


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_from,n_to", [(1, 2), (2, 4), (4, 2), (2, 1)])
def test_resize_equals_restore(n_from, n_to):
    """``resize(M)`` morphs the engine in place into the engine
    ``restore_engine(snapshot(), n_shards=M)`` builds; both continue
    bitwise alike, and every Stream handle stays valid."""
    K = 3
    srcs, eng = _build(P, _cfg(P, n_shards=n_from, superstep=K))
    _, ts = _run(eng, srcs, range(3), 1, K)
    oracle = P.restore_engine(eng.snapshot(), n_shards=n_to, device="cpu")
    reg = eng.registry
    assert eng.resize(n_to) is eng and eng.registry is reg
    assert eng.cfg.n_shards == reg.cfg.n_shards == n_to
    assert type(eng).__name__ == ("ShardedStreamEngine" if n_to > 1
                                  else "StreamEngine")
    assert_same(eng, oracle, "at the resize")
    sinks_e, _ = _run(eng, srcs, range(3, 6), ts, K)
    sinks_o, _ = _run(oracle, srcs, range(3, 6), ts, K)
    sinks_e += eng.drain()
    sinks_o += oracle.drain()
    assert_same_sinks(sinks_e, sinks_o, "continued")
    assert_same(eng, oracle, "continued")
    for s in srcs:
        np.testing.assert_array_equal(eng.value_of(s), oracle.value_of(s))
    assert eng.resize(n_to) is eng
    with pytest.raises(ValueError):
        eng.resize(0)


def test_resize_chain_matches_repro():
    """1->2->4->2->1 with traffic (and queued SUs) between hops, through
    both packages: every snapshot array and sink equal after every hop
    and its continuation; the port's second visit to 2 shards and its
    return to 1 reuse the round closures of the first."""
    K = 3
    engines, all_srcs = [], []
    for mod in (J, P):
        srcs, eng = _build(mod, _cfg(mod, superstep=K))
        engines.append(eng)
        all_srcs.append(srcs)
    ej, ep = engines
    ts, w, fns = 1, 0, {}
    for e, s in zip(engines, all_srcs):
        _, ts_next = _run(e, s, range(w, w + 2), ts, K)
    ts, w = ts_next, w + 2
    fns[1] = ep._fns
    for n_to in (2, 4, 2, 1):
        for e in engines:
            e.resize(n_to)
        assert_same(ej, ep, f"resize to {n_to}")
        if n_to in fns:
            assert ep._fns is fns[n_to]
        fns[n_to] = ep._fns
        sinks = [_run(e, s, [w], ts, K) for e, s in zip(engines, all_srcs)]
        ts, w = sinks[0][1], w + 1
        assert_same_sinks(sinks[0][0], sinks[1][0], f"continued at {n_to}")
        assert_same(ej, ep, f"continued at {n_to}")
    assert type(ep).__name__ == "StreamEngine"


# --------------------------------------------------------------------------
# the autoscaler
# --------------------------------------------------------------------------

def test_autoscaler_matches_repro():
    """``tests/test_elastic.py``'s feed (four depth-3 pipelines overfed,
    then idle): both packages scale up under the burst and back down when
    idle, with the same events, and end in the same engine."""
    runs = []
    for mod, scaler in ((J, JAutoscaler), (P, PAutoscaler)):
        cfg = _cfg(mod, n_shards=1, superstep=2, queue=16, batch=4,
                   retention_slots=0, dlq_slots=0)
        reg = mod.Registry.with_capacity(cfg)
        t = reg.create_tenant("t")
        srcs = [reg.create_stream(t, f"a{i}", ["v"]) for i in range(4)]
        for i, a in enumerate(srcs):
            b = reg.create_composite(t, f"b{i}", ["v"], [a],
                                     {"v": "in0.v + 1"})
            c = reg.create_composite(t, f"c{i}", ["v"], [b],
                                     {"v": "in0.v + 1"})
            reg.create_composite(t, f"d{i}", ["v"], [c], {"v": "in0.v + 1"})
        eng = _engine(mod, reg)
        sc = scaler(eng, min_shards=1, max_shards=4, up=0.25, down=0.05,
                    patience=1, cooldown=0)
        ts = 1
        for w in range(12):                  # burst: overfeed the queue
            for j in range(2):
                for s in srcs:
                    eng.post(s, [float(8 * w + j)], ts)
                ts += 1
            eng.superstep(2)
            sc.observe()
            if eng.cfg.n_shards == 4:
                break
        for _ in range(24):                  # quiet: drain, then idle
            eng.superstep(2)
            sc.observe()
            if eng.cfg.n_shards == 1 and sc.occupancy() == 0.0:
                break
        runs.append((eng, sc))
    (ej, sj), (ep, sp) = runs
    assert [dataclasses.asdict(e) for e in sp.events] == \
        [dataclasses.asdict(e) for e in sj.events]
    assert any(e.to_shards > e.from_shards for e in sp.events)
    assert any(e.to_shards < e.from_shards for e in sp.events)
    assert ep.cfg.n_shards == 1 and sp.engine is ep
    assert_same(ej, ep, "final engine")


def test_autoscaler_bounds():
    srcs, eng = _build(P, _cfg(P))
    with pytest.raises(ValueError):
        PAutoscaler(eng, min_shards=2, max_shards=1)
    with pytest.raises(ValueError):
        PAutoscaler(eng, up=0.2, down=0.5)
    sc = PAutoscaler(eng, min_shards=1, max_shards=1)
    for _ in range(4):                       # the bounds pin it at 1
        eng.round()
        assert sc.observe() is None
    assert eng.cfg.n_shards == 1 and sc.events == []
