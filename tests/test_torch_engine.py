"""The slice as a whole: the port's single-device engine round against the
JAX package's, bitwise, through whole histories.

After every round every ``EngineState`` leaf, every stat, the round's
sink and the dead-letter spool of the port equal ``repro``'s (float32
compared as bits, so -0.0 and NaN payloads count).  Covered: the fused
and the staged path (and port-fused == port-staged), the QoS plane
(weights + quotas), the circuit breaker (NaN program output -> trip ->
quarantine -> purge), the path flip on a transcendental program, and a
``repro`` snapshot carried into the port mid-history."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU ops here are tiny: one thread, so that parallel test workers
# do not contend for the cores through torch's thread pools
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _create(mod, reg):
    return mod.create_engine(reg, **({"device": "cpu"} if mod is P else {}))


def _build(mod, fused, hot=False, **cfg_kw):
    """tests/test_round_fuse.py's history: two tenants, six sources, two
    chained composites, with the DLQ and retention rings on."""
    kw = dict(n_streams=64, n_tenants=4, channels=3, max_in=4, max_out=4,
              batch=8, queue=128, prog_len=16, n_consts=8, n_temps=8,
              sink_buffer=32, dlq_slots=16, retention_slots=2,
              fused_round=fused)
    kw.update(cfg_kw)
    reg = mod.Registry(mod.EngineConfig(**kw).validate())
    t0, t1 = reg.create_tenant("a"), reg.create_tenant("b")
    srcs = [reg.create_stream(t0, f"s{i}", ["x", "y", "z"]) for i in range(6)]
    c0 = reg.create_composite(t0, "c0", ["x", "y", "z"], srcs[:3],
                              {"x": "s0.x + s1.y", "y": "out.y + 1",
                               "z": "min(s2.z, 4.0)"},
                              post_filter="out.x < 100")
    reg.create_composite(t1, "c1", ["x", "y", "z"], [srcs[3], c0],
                         {"x": "c0.x * 2", "y": "s3.y - c0.z",
                          "z": "abs(s3.z)"})
    if hot:
        reg.create_composite(t1, "hot", ["x", "y", "z"], [srcs[4]],
                             {"x": "tanh(s4.x)", "y": "s4.y", "z": "s4.z"})
    return _create(mod, reg), (t0, t1), srcs


def _post(engines, srcs, rng, r, p=0.8, nan_every=0):
    for i, s in enumerate(srcs):
        if rng.random() < p:
            v = rng.standard_normal(3).astype(np.float32)
            if nan_every and (r + i) % nan_every == 0:
                v[0] = np.nan
            if i == 1 and r % 3 == 0:
                v[1] = -0.0
            t = r * 10 + int(rng.integers(0, 9))
            for e in engines:
                e.post(s.sid, v.tolist(), t)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(eng, sink=None):
    out = {}
    for f in eng.state._fields:
        if f == "stats":
            for k, v in eng.state.stats.items():
                out[f"stats/{k}"] = _host(v)
        else:
            out[f"state/{f}"] = _host(getattr(eng.state, f))
    if sink is not None:
        for f in sink._fields:
            out[f"sink/{f}"] = _host(getattr(sink, f))
    for i, lt in enumerate(eng.dead_letters(clear=False)):
        out[f"dlq{i}"] = np.asarray([lt.sid, lt.ts, lt.tenant, lt.its,
                                     ("overflow", "revoked", "spool", "quota",
                                      "poisoned").index(lt.reason)])
        out[f"dlq{i}/vals"] = np.asarray(lt.vals)
    return out


def assert_same(a, b, where=""):
    la, lb = (_leaves(*x) if isinstance(x, tuple) else _leaves(x)
              for x in (a, b))
    assert la.keys() == lb.keys(), where
    for k in la:
        x, y = la[k], lb[k]
        assert x.shape == y.shape and x.dtype == y.dtype, f"{where} {k}"
        np.testing.assert_array_equal(
            x.view(np.int32) if x.dtype == np.float32 else x,
            y.view(np.int32) if y.dtype == np.float32 else y,
            err_msg=f"{where} {k}")


def _lockstep(ej, ep, srcs, rounds, seed, each_round=None, **post_kw):
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        if each_round:
            each_round(r)
        _post([ej, ep], srcs, rng, r, **post_kw)
        sj, sp = ej.round(), ep.round()
        assert_same((ej, sj), (ep, sp), f"round {r}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_history_bitwise_equal_to_jax(fused):
    ej, _, sj = _build(J, fused)
    ep, _, sp = _build(P, fused)
    assert ej._path == ep._path == ("fused" if fused else "staged")
    _lockstep(ej, ep, sj, 12, seed=7)
    assert ep.counters()["emitted"] > 0
    assert ej.counters() == ep.counters()


def test_port_fused_equals_port_staged():
    e1, _, s1 = _build(P, True)
    e0, _, _ = _build(P, False)
    assert (e1._path, e0._path) == ("fused", "staged")
    _lockstep(e1, e0, s1, 12, seed=9)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_qos_weights_and_quotas_bitwise(fused):
    """Weighted-fair pop and token-bucket quotas, edited mid-history; a
    small queue keeps tenants backlogged so the weights matter."""
    ej, (j0, j1), sj = _build(J, fused, queue=8, batch=4)
    ep, (p0, p1), _ = _build(P, fused, queue=8, batch=4)

    def knobs(r):
        if r == 1:
            for e, t0, t1 in ((ej, j0, j1), (ep, p0, p1)):
                e.set_weight(t0, 3)
                e.set_weight(t1, 1)
                e.set_quota(t0, 2, burst=3)
        if r == 6:
            for e, t0, t1 in ((ej, j0, j1), (ep, p0, p1)):
                e.set_quota(t0, 1)
                e.set_weight(t1, 1 << 20)        # clipped to FAIR_SCALE
        if r == 9:
            for e, t0 in ((ej, j0), (ep, p0)):
                e.set_quota(t0, 0)
    _lockstep(ej, ep, sj, 12, seed=3, each_round=knobs, p=1.0)
    c = ep.counters()
    assert c["dropped_quota"] > 0 and c["popped"] > 0
    np.testing.assert_array_equal(np.asarray(ej.tables.weight),
                                  ep.tables.weight.numpy())
    np.testing.assert_array_equal(ej.tenant_backlog(), ep.tenant_backlog())


def _poison(mod, fused):
    cfg = mod.EngineConfig(n_streams=16, n_tenants=4, channels=1, batch=4,
                           queue=32, max_in=4, max_out=4, prog_len=24,
                           n_consts=8, n_temps=12, sink_buffer=8,
                           retention_slots=2, dlq_slots=16, fault_window=6,
                           fault_threshold=2, fused_round=fused).validate()
    reg = mod.Registry.with_capacity(cfg)
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    comp = reg.create_composite(t, "comp", ["v"], [src], {"v": "src.v * 2.0"})
    reg.create_composite(t, "down", ["v"], [comp], {"v": "comp.v + 1.0"})
    return _create(mod, reg), src, comp


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_breaker_trips_and_quarantines_bitwise(fused):
    """NaN payloads make ``comp``'s program non-finite; two faults in the
    window trip it, it is quarantined on device, its queued SUs purge to
    the DLQ as poisoned, and later SUs posted to it are shed."""
    ej, src_j, comp_j = _poison(J, fused)
    ep, _, _ = _poison(P, fused)
    ej.set_breaker(amp_ceiling=3)
    ep.set_breaker(amp_ceiling=3)
    rng = np.random.default_rng(1)
    for r in range(10):
        v = np.nan if r in (1, 2, 3) else float(rng.standard_normal())
        for e in (ej, ep):
            e.post(src_j.sid, [v], ts=10 * r)
            if r >= 6:
                e.post(comp_j.sid, [1.0], ts=10 * r + 1)
        assert_same((ej, ej.round()), (ep, ep.round()), f"round {r}")
    fc = ep.fault_counters()
    assert fc["quarantined"][comp_j.sid] and fc["fault_total"][comp_j.sid] >= 2
    c = ep.counters()
    assert c["nonfinite"] > 0 and c["dropped_poisoned"] > 0
    for key in ("quarantined", "fault_count", "fault_total"):
        np.testing.assert_array_equal(ej.fault_counters()[key], fc[key])
    lj, lp = ej.dead_letters(), ep.dead_letters()
    assert [x.reason for x in lj] == [x.reason for x in lp]
    assert ep.state.dlq_fill.item() == 0


def test_transcendental_program_takes_the_staged_path():
    """A tanh program makes the fused config run staged in both packages,
    and the staged histories stay bitwise equal (tanh itself agrees only
    within an ulp bound, so its outputs are compared up to that bound
    through the VM tests; here the program's value is filtered out)."""
    ej, _, sj = _build(J, True, hot=True)
    ep, _, _ = _build(P, True, hot=True)
    assert ej._path == ep._path == "staged"
    rng = np.random.default_rng(2)
    for r in range(6):
        _post([ej, ep], sj[:4], rng, r)          # s4 (tanh's input) idle
        assert_same((ej, ej.round()), (ep, ep.round()), f"round {r}")
    ep._note_program(ep.registry.streams[-1].sid, None)
    assert ep._path == "fused"


def test_snapshot_carried_across_continues_bitwise():
    """Five rounds in ``repro``, its snapshot installed in a port engine,
    then five more rounds in both: bitwise equal all along, and the port's
    own snapshot has the same keys and arrays as ``repro``'s."""
    ej, _, sj = _build(J, True)
    rng = np.random.default_rng(4)
    for r in range(5):
        _post([ej], sj, rng, r)
        ej.round()
    _post([ej], sj, rng, 5)                     # a pending backlog too
    arrays, meta = ej.snapshot()
    ep = P.engine_from_snapshot(arrays, meta, device="cpu")
    assert ep._path == "fused" and ep._rounds_done == 5
    assert_same(ej, ep, "restored")
    pa, pm = ep.snapshot()
    assert pa.keys() == arrays.keys() and pm == meta
    for k in arrays:
        np.testing.assert_array_equal(pa[k], arrays[k], err_msg=k)
    for r in range(6, 11):
        sa, sb = ej.round(), ep.round()
        assert_same((ej, sa), (ep, sb), f"round {r}")
        _post([ej, ep], sj, rng, r)


def test_snapshot_install_reaches_the_admission_hook(monkeypatch):
    """Installing a snapshot rebinds every table and state tensor, so it
    calls ``_sync_admitted`` last, as ``repro``'s install does (the point
    where a captured round would be captured again)."""
    ep, _, sp = _build(P, True)
    rng = np.random.default_rng(7)
    for r in range(3):
        _post([ep], sp, rng, r)
        ep.round()
    arrays, meta = ep.snapshot()
    fresh = P.engine_from_snapshot(arrays, meta, device="cpu")
    calls = []
    monkeypatch.setattr(PE.StreamEngine, "_sync_admitted",
                        lambda self: calls.append(
                            (self, self.tables, self.state)))
    fresh._install_snapshot(arrays, meta)
    assert len(calls) == 1
    eng, tables, state = calls[0]
    assert eng is fresh and tables is fresh.tables and state is fresh.state


def test_engine_defaults_to_cuda_and_refuses_the_cpu_silently():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    reg = P.Registry(P.EngineConfig(n_streams=4, batch=2, queue=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        P.create_engine(reg)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.StreamEngine(reg)


def test_unported_planes_raise():
    """PRED flows (raising until the serving slice) build on the engine,
    each with its model-backed stream and response; the sharded snapshot,
    which raised until the durability plane was ported, restores into an
    engine of the same layout."""
    from types import SimpleNamespace

    from repro_torch.workloads import TraceConfig, build_suite, drive
    from repro_torch.workloads import wire_pred
    suite = build_suite(2, kinds=("pred",), device="cpu",
                        trace=TraceConfig(n_devices=2, rounds=4,
                                          base_rate=1.0))
    assert [f.kind for f in suite.flows] == ["pred", "pred"]
    mb = suite.engine.tables.model_backed.cpu().numpy()
    assert sorted(np.nonzero(mb)[0].tolist()) == sorted(
        f.model.sid for f in suite.flows)
    queue = []                      # a stub batcher: echo every prompt

    def run_ticks(n):
        done = queue[:]
        queue.clear()
        for r in done:
            r.output = list(r.prompt)
        return done
    bridge = wire_pred(suite, SimpleNamespace(
        cfg=SimpleNamespace(vocab=64), submit=queue.append,
        run_ticks=run_ticks))
    assert drive(suite)["records"] > 0
    assert len(bridge.completed) >= 4 and not bridge.inflight
    sharded = P.Registry(P.EngineConfig(n_streams=4, batch=2, queue=4,
                                        n_shards=2))
    eng = P.create_engine(sharded, device="cpu")
    arrays, meta = eng.snapshot()
    assert meta["kind"] == "sharded"
    back = P.restore_engine((arrays, meta), device="cpu")
    assert type(back) is type(eng) and back.plan.n_shards == 2
    for k, v in back.snapshot()[0].items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    assert PE.RANK_LIM * PE.FAIR_SCALE <= np.iinfo(np.int32).max
