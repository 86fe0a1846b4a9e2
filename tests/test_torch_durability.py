"""The port's durability plane against the JAX package's, bitwise.

* Kill and resume in the port (``tests/test_durability.py``'s
  differential): an engine checkpointed mid-flight, deleted and restored
  from disk continues bit for bit with an engine that never stopped, at 1
  and 2 shards, rounds and supersteps; the ``checkpoint_every`` cadence.
* Restore across packages: a ``repro`` checkpoint on disk restored by the
  port continues bitwise with ``repro``, and a port checkpoint restored by
  ``repro`` continues bitwise with the port, at 1 and 2 shards.
* Snapshots from before the fault and latency planes (their keys removed)
  install in both packages with the same defaults; clearing the spool
  calls the engine's admission hook once.
* Replay to a late joiner, quota-shed redelivery, a revoked stream's
  purged queue refused and spooled again (``redeliver_rejected``), spool
  overflow, and the dead-letter spool across snapshot and restore, driven
  through both packages in lockstep at 1 and 2 shards: every snapshot
  array and the dead letters equal after every step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.core.engine as PE  # noqa: E402
from repro.checkpoint.ckpt import CheckpointManager as JManager  # noqa: E402
from repro_torch.checkpoint.ckpt import \
    CheckpointManager as PManager, all_steps  # noqa: E402


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


def _restore(mod, source, **kw):
    return mod.restore_engine(source, **({"device": "cpu"} if mod is P
                                         else {}), **kw)


def _build(mod, cfg):
    """``tests/test_durability.py``'s multi-hop topology."""
    reg = mod.Registry.with_capacity(cfg)
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
    return srcs, _engine(mod, reg)


def _post_wave(eng, srcs, wave, base_ts):
    for i, s in enumerate(srcs):
        eng.post(s, [float(10 * wave + i)], base_ts)
    eng.post(srcs[0], [float(wave)], base_ts + 1)
    eng.post(srcs[2], [float(100 + wave)], base_ts + 2)


def _run(eng, srcs, waves, ts, K):
    """Post each wave and run one round (K = 1) or superstep; returns the
    per-round sinks and the next timestamp."""
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


def assert_same(a, b, where):
    """Every snapshot array (tables, state, stats, dead-letter spool, maps,
    backlog) bitwise, the registry mirror and the host counters equal."""
    (xa, ma), (xb, mb) = a.snapshot(), b.snapshot()
    assert sorted(xa) == sorted(xb), where
    for k in xa:
        u, v = _bits(xa[k]), _bits(xb[k])
        assert u.dtype == v.dtype and u.shape == v.shape, f"{where} {k}"
        np.testing.assert_array_equal(u, v, err_msg=f"{where} {k}")
    assert ma == mb, where


def assert_same_sinks(sa, sb, where):
    assert len(sa) == len(sb), where
    for i, (x, y) in enumerate(zip(sa, sb)):
        for f, u, v in zip(x._fields, x, y):
            np.testing.assert_array_equal(_bits(u), _bits(v),
                                          err_msg=f"{where} sink {i} {f}")


# --------------------------------------------------------------------------
# kill and resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("K", [1, 3])
def test_kill_and_resume_bit_identical(tmp_path, n_shards, K):
    """Two identical port engines; one is checkpointed mid-flight, deleted
    and restored from disk, then both continue on the same input: every
    snapshot array and every sink bitwise."""
    cfg = _cfg(P, n_shards=n_shards, superstep=K)
    srcs, eng_a = _build(P, cfg)
    _, eng_b = _build(P, cfg)
    ts = 1
    for eng in (eng_a, eng_b):
        _, ts_next = _run(eng, srcs, range(3), ts, K)
    ts = ts_next
    PManager(str(tmp_path), keep=2).save_sync(eng_a._steps_done,
                                              *eng_a.snapshot())
    del eng_a                                # the crash
    eng_r = P.restore_engine(str(tmp_path), device="cpu")
    assert type(eng_r).__name__ == ("ShardedStreamEngine" if n_shards > 1
                                    else "StreamEngine")
    assert_same(eng_r, eng_b, "resume point")
    sinks_r, _ = _run(eng_r, srcs, range(3, 6), ts, K)
    sinks_b, _ = _run(eng_b, srcs, range(3, 6), ts, K)
    sinks_r += eng_r.drain()
    sinks_b += eng_b.drain()
    assert_same(eng_r, eng_b, "after the suffix")
    assert_same_sinks(sinks_r, sinks_b, "suffix")


def test_checkpoint_every_cadence(tmp_path):
    """``checkpoint_to`` snapshots every ``checkpoint_every``-th boundary
    asynchronously and prunes to ``keep``; a restored engine keeps
    counting from the restored boundary."""
    srcs, eng = _build(P, _cfg(P, checkpoint_every=2))
    mgr = eng.checkpoint_to(str(tmp_path), keep=2)
    _run(eng, srcs, range(6), 1, 1)
    mgr.wait()
    assert all_steps(str(tmp_path)) == [4, 6]     # every 2nd, keep 2
    eng_r = P.restore_engine(mgr, device="cpu")
    assert eng_r._steps_done == 6
    assert_same(eng_r, eng, "restored from the manager")
    eng_r.checkpoint_to(str(tmp_path), keep=2)
    eng_r.round()
    eng_r.round()
    eng_r.checkpoint_to(None)                # awaits the write, detaches
    assert eng_r._ckpt is None
    assert all_steps(str(tmp_path)) == [6, 8]


# --------------------------------------------------------------------------
# restore across packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("writer,reader", [(J, P), (P, J)],
                         ids=["repro_to_port", "port_to_repro"])
def test_restore_across_packages(tmp_path, writer, reader, n_shards):
    """A checkpoint one package writes to disk is restored by the other,
    and the restored engine continues bitwise with the writer's engine,
    which never stopped (superstep K = 2, queued SUs and dead letters in
    the checkpoint)."""
    K = 2
    cfg = _cfg(writer, n_shards=n_shards, superstep=K, queue=16, batch=4)
    srcs, eng_w = _build(writer, cfg)
    _, ts = _run(eng_w, srcs, range(3), 1, K)
    eng_w.revoke_stream(eng_w.registry.streams[srcs[3].sid])
    manager = JManager if writer is J else PManager
    manager(str(tmp_path), keep=1).save_sync(eng_w._steps_done,
                                             *eng_w.snapshot())
    eng_r = _restore(reader, str(tmp_path))
    assert eng_r.cfg.n_shards == n_shards
    assert_same(eng_r, eng_w, "restored")
    sinks_r, _ = _run(eng_r, srcs[:3], range(3, 6), ts, K)
    sinks_w, _ = _run(eng_w, srcs[:3], range(3, 6), ts, K)
    assert_same(eng_r, eng_w, "continued")
    assert_same_sinks(sinks_r, sinks_w, "continued")


# --------------------------------------------------------------------------
# the two repairs: older snapshots, and the hook when the spool clears
# --------------------------------------------------------------------------

_NEWER_KEYS = ("tables/breaker", "state/quarantined", "state/fault_count",
               "state/fault_epoch", "state/fault_total", "state/round_idx",
               "state/stats/dropped_poisoned",
               "state/stats/redeliver_rejected", "pending/its")


@pytest.mark.parametrize("n_shards", [1, 2])
def test_older_snapshot_installs_with_repro_defaults(n_shards):
    """A ``repro`` snapshot without the fault plane's, the breaker's and
    the latency plane's keys installs in both packages (breaker knobs
    from the config, fault leaves, stats and ingest stamps zero), and both
    continue bitwise."""
    cfg = _cfg(J, n_shards=n_shards, fault_threshold=2, fault_window=4)
    srcs, eng = _build(J, cfg)
    _, ts = _run(eng, srcs, range(2), 1, 1)
    _post_wave(eng, srcs, 2, ts)             # a backlog for pending/its
    arrays, meta = eng.snapshot()
    arrays = {k: v for k, v in arrays.items() if k not in _NEWER_KEYS}
    assert arrays["pending/sid"].size
    eng_j = _restore(J, (arrays, meta))
    eng_p = _restore(P, (arrays, meta))
    assert_same(eng_p, eng_j, "installed")
    brk = eng_p.tables.breaker.cpu().numpy().reshape(-1, 3)
    assert (brk == [4, 2, 0]).all() and brk.shape[0] == n_shards
    sinks_p, _ = _run(eng_p, srcs, range(3, 5), ts + 4, 1)
    sinks_j, _ = _run(eng_j, srcs, range(3, 5), ts + 4, 1)
    assert_same(eng_p, eng_j, "continued")
    assert_same_sinks(sinks_p, sinks_j, "continued")


def test_clearing_the_spool_calls_the_admission_hook(monkeypatch):
    """``dead_letters(clear=True)`` clears through
    ``admission.clear_dead_letters`` (in place) and then calls
    ``_sync_admitted`` once, as ``repro`` does."""
    srcs, eng = _build(P, _cfg(P))
    eng.post(srcs[0], [1.0], 5)
    eng.revoke_stream(srcs[0])               # its SU drops at ingest
    eng.round()
    fill = eng.state.dlq_fill
    calls = []
    monkeypatch.setattr(PE.StreamEngine, "_sync_admitted",
                        lambda self: calls.append(self))
    assert [lt.reason for lt in eng.dead_letters(clear=False)] == ["revoked"]
    assert calls == []
    assert len(eng.dead_letters()) == 1
    assert calls == [eng]
    assert eng.state.dlq_fill is fill and int(fill) == 0
    assert eng.dead_letters() == [] and calls == [eng]


# --------------------------------------------------------------------------
# replay, redelivery and the spool, in lockstep with repro
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
def test_replay_and_redelivery_match_repro(n_shards):
    """One script through both packages (rounds, and one superstep of 4
    whose spool of 2 overflows), every snapshot array equal after each
    step:

    1. history retained by a source is replayed to a late joiner
       (``admit_subscription(replay=True)``) before live data;
    2. quota-shed SUs are drained and redelivered through ingest;
    3. a revoked stream's purged queue is redelivered: refused, spooled
       again with reason and stamps kept, counted in
       ``redeliver_rejected``;
    4. a burst overflows the superstep's sink spool into the DLQ;
    5. the spool survives a snapshot and restore, then redelivers;
    and the rounds after each step."""
    engines, handles = [], []
    for mod in (J, P):
        cfg = _cfg(mod, n_shards=n_shards, sink_spool_slots=2)
        reg = mod.Registry.with_capacity(cfg)
        t = reg.create_tenant("t")
        s0, s1, s2 = (reg.create_stream(t, f"s{i}", ["v"]) for i in range(3))
        mid = reg.create_composite(t, "mid", ["v"], [s0], {"v": "in0.v"})
        reg.create_composite(t, "end", ["v"], [mid], {"v": "in0.v + 1"})
        engines.append(_engine(mod, reg))
        handles.append((t, s0, s1, s2, mid))
    steps = []

    def step(name, fn):
        out = [fn(e, *h) for e, h in zip(engines, handles)]
        assert out[0] == out[1], f"{name}: {out}"
        assert_same(*engines, name)
        steps.append(name)
        return out[0]

    def history(e, t, s0, s1, s2, mid):
        for i in range(4):
            e.post(s0, [float(i)], ts=i + 1)
        e.drain()

    def replay(e, t, s0, s1, s2, mid):
        late = e.admit_composite(t, "late", ["v"], [s1], {"v": "in0.v"})
        ok = e.admit_subscription(late, s0, replay=True)
        e.swap_program(late, {"v": "in0.v + in1.v * 2"})
        e.drain()
        c = e.counters()
        return ok, c["replayed"], e.ts_of(late), float(e.value_of(late)[0])

    assert step("history", history) is None
    assert step("replay", replay) == (True, 4, 4, 6.0)

    def quota(e, t, s0, s1, s2, mid):
        e.set_quota(t, 1)
        for i, s in enumerate((s0, s1, s2)):
            e.post(s, [float(20 + i)], ts=20)
        e.round()
        shed = [(lt.sid, lt.reason) for lt in e.dead_letters(clear=False)]
        e.set_quota(t, 0)
        n = e.redeliver()
        e.drain()
        return shed, n, e.counters()["dropped_quota"]

    shed, n, dq = step("quota-shed redelivery", quota)
    assert n == dq == len(shed) == 2 and {r for _, r in shed} == {"quota"}

    def revoked(e, t, s0, s1, s2, mid):
        e.post(s0, [7.0], ts=50)
        e.round()                            # mid emitted, queued for end
        e.revoke_stream(mid)
        n = e.redeliver()
        kept = [(lt.sid, lt.reason, lt.ts, float(lt.vals[0]))
                for lt in e.dead_letters(clear=False)]
        e.drain()
        return n, kept, e.counters()["redeliver_rejected"]

    n, kept, rej = step("revoked purge respooled", revoked)
    assert n == 0 and rej == len(kept) >= 1
    assert all(r == "revoked" for _, r, _, _ in kept)

    def spool(e, t, s0, s1, s2, mid):
        for k in range(4):
            for i, s in enumerate((s0, s1, s2)):
                e.post(s, [float(60 + k + i)], ts=60 + k)
        e.superstep(4)
        c = e.counters()
        return c["dropped_spool"], sum(lt.reason == "spool" for lt in
                                       e.dead_letters(clear=False))

    dropped, spooled = step("spool overflow", spool)
    assert dropped > 0 and spooled > 0

    def survive(e, t, s0, s1, s2, mid):
        mod = J if isinstance(e, J.StreamEngine) else P
        r = _restore(mod, e.snapshot())
        assert_same(r, e, "restored spool")
        letters = [(lt.sid, lt.reason, lt.ts, lt.its, lt.tenant)
                   for lt in r.dead_letters(clear=False)]
        e.redeliver()
        e.drain()
        return letters

    assert step("spool across restore", survive)
    assert len(steps) == 6


def test_replay_wraps_the_retention_ring():
    """More emissions than retention slots: a late joiner is replayed
    exactly the newest ``retention_slots`` SUs, oldest first; without
    retention the replay is a no-op."""
    for slots, want in ((3, [6, 7, 8]), (0, [])):
        reg = P.Registry.with_capacity(_cfg(P, retention_slots=slots))
        t = reg.create_tenant("t")
        s0, s1 = (reg.create_stream(t, f"s{i}", ["v"]) for i in range(2))
        eng = _engine(P, reg)
        for i in range(8):
            eng.post(s0, [float(i)], ts=i + 1)
        eng.drain()
        late = eng.admit_composite(t, "late", ["v"], [s1], {"v": "in0.v"})
        assert eng.admit_subscription(late, s0, replay=True)
        q = eng.state
        got = sorted(q.q_ts[q.q_valid].tolist())
        assert got == want
        eng.drain()
        assert eng.counters()["replayed"] == len(want)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_durability_edits_keep_storage(n_shards):
    """Replay, redelivery (requeue and respool) and clearing the spool
    write into the state's own tensors: no state tensor or stat moves."""
    cfg = _cfg(P, n_shards=n_shards, queue=16, batch=4)
    srcs, eng = _build(P, cfg)
    _run(eng, srcs, range(3), 1, 1)

    def ptrs():
        st = eng.state
        out = {f: getattr(st, f).data_ptr() for f in st._fields
               if f != "stats"}
        out.update({f"stats/{k}": v.data_ptr() for k, v in st.stats.items()})
        return out

    before = ptrs()
    late = eng.admit_composite(eng.registry.tenants[0], "late", ["v"],
                               [srcs[1]], {"v": "in0.v"})
    assert eng.admit_subscription(late, srcs[0], replay=True)
    eng.revoke_stream(eng.registry.streams[srcs[3].sid])
    letters = eng.dead_letters()
    assert letters and eng.redeliver(letters) < len(letters)
    assert eng.counters()["redeliver_rejected"] > 0
    eng.dead_letters()
    assert ptrs() == before
