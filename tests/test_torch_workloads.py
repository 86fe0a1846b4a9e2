"""The port's IoT workload suite (ETL + STATS through supersteps) against
the JAX package's, bitwise: per-superstep latency records, the SLO
histograms and report, the engine's counters and the window aggregates,
on both round paths at K in {1, 3}.  PRED flows served through the
bridge by a gemma3-1b SMOKE batcher (float32) at 1 and 2 shards: the
records, SLO histograms and report, completions, response SUs and every
state leaf equal ``repro``'s.  Also the latency plane's pin (sink
records carry global emission rounds), the copied trace and SLO tracker,
and PRED flows building, wiring and driving with a stub batcher."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.workloads as JWL  # noqa: E402
import repro_torch.workloads as PWL  # noqa: E402
from repro.core import EngineConfig as JCfg, Registry as JReg  # noqa: E402
from repro.core import create_engine as j_create  # noqa: E402
from repro.core.slo import SLOTracker as JSLO  # noqa: E402
from repro.core.slo import weights_from_slo as j_weights  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher  # noqa: E402
from repro.workloads.runner import sink_records as j_sink_records  # noqa: E402
from repro_torch.core import EngineConfig, Registry, create_engine  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.slo import SLOTracker, weights_from_slo  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import ContinuousBatcher as PBatcher  # noqa: E402
from repro_torch.workloads.runner import sink_records, wire_pred  # noqa: E402

PATHS = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "staged"])


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _suite(pkg, fused, K, **kw):
    extra = {"device": "cpu"} if pkg is PWL else {}
    return pkg.build_suite(
        4, kinds=("etl", "stats"), fused_round=fused,
        trace=pkg.TraceConfig(n_devices=4, rounds=8, seed=11),
        cfg_overrides={"superstep": K}, **extra, **kw)


def _drive_suite(pkg, fused, K):
    """tests/test_iot_latency.py's ``_drive_suite``: per-superstep
    latency records, folded into the SLO tracker."""
    suite = _suite(pkg, fused, K)
    sink_recs = j_sink_records if pkg is JWL else sink_records
    eng = suite.engine
    per_step = []
    for k, dev, vals in suite.trace.steps():
        for d, v in zip(dev, vals):
            eng.post(suite.flows[d].source, [float(v)], ts=k + 1)
        per_step.append(eng.latency_records(eng.superstep(K)))
    for _ in range(3):
        per_step.append(eng.latency_records(eng.superstep(K)))
    for recs in per_step:
        suite.slo.observe(sink_recs(recs, suite.sink_sids))
    return suite, per_step


@PATHS
@pytest.mark.parametrize("K", [1, 3])
def test_latency_records_and_slo_bitwise(fused, K):
    sj, rj = _drive_suite(JWL, fused, K)
    sp, rp = _drive_suite(PWL, fused, K)
    assert sp.engine._path == sj.engine._path == (
        "fused" if fused else "staged")
    assert len(rj) == len(rp)
    for x, y in zip(rj, rp):
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)
    assert sum(r["sid"].size for r in rp) > 0
    np.testing.assert_array_equal(sj.slo.hist, sp.slo.hist)
    np.testing.assert_array_equal(sj.slo.violations, sp.slo.violations)
    assert sj.slo.slo_report() == sp.slo.slo_report()


@PATHS
@pytest.mark.parametrize("K", [1, 3])
def test_drive_bitwise(fused, K):
    """``drive()`` end to end: records, SLO report, the five window
    aggregates (bitwise: W = 8 <= 32), and the engine's counters."""
    sj, sp = _suite(JWL, fused, K), _suite(PWL, fused, K)
    rj, rp = JWL.drive(sj, K), PWL.drive(sp, K)
    assert rp["records"] == rj["records"] > 0
    assert rp["slo_report"] == rj["slo_report"]
    assert rp["aggregates"].keys() == rj["aggregates"].keys()
    for k in rj["aggregates"]:
        np.testing.assert_array_equal(_bits(rp["aggregates"][k]),
                                      _bits(rj["aggregates"][k]), err_msg=k)
    assert rp["aggregates"]["count"].any()
    assert sp.engine.counters() == sj.engine.counters()
    for f in ("values", "timestamps", "q_valid", "tenant_emitted"):
        np.testing.assert_array_equal(
            _bits(getattr(sp.engine.state, f)),
            _bits(getattr(sj.engine.state, f)), err_msg=f)
    store_j, store_p = sj.stats.store, sp.stats.store
    for f in store_j._fields:
        np.testing.assert_array_equal(_bits(getattr(store_p, f)),
                                      _bits(getattr(store_j, f)), err_msg=f)


def test_two_shard_drive_bitwise():
    """``drive()`` on a 2-shard suite (fused, K = 3) against ``repro``'s
    2-shard suite: records, SLO report, window aggregates, counters and
    every state leaf with its shard axis; and equal to the port's
    1-shard suite on the records and the report."""
    K = 3
    sj = _suite(JWL, True, K, n_shards=2)
    sp = _suite(PWL, True, K, n_shards=2)
    s1 = _suite(PWL, True, K)
    rj, rp, r1 = JWL.drive(sj, K), PWL.drive(sp, K), PWL.drive(s1, K)
    assert sp.engine.plan.n_shards == 2
    assert rp["records"] == rj["records"] == r1["records"] > 0
    assert rp["slo_report"] == rj["slo_report"] == r1["slo_report"]
    for k in rj["aggregates"]:
        np.testing.assert_array_equal(_bits(rp["aggregates"][k]),
                                      _bits(rj["aggregates"][k]), err_msg=k)
    assert sp.engine.counters() == sj.engine.counters()
    for f in sj.engine.state._fields:
        if f != "stats":
            np.testing.assert_array_equal(
                _bits(getattr(sp.engine.state, f)),
                _bits(getattr(sj.engine.state, f)), err_msg=f)


def _chain_cfg(mod):
    return mod(n_streams=16, n_tenants=4, channels=2, max_in=2, max_out=2,
              batch=8, queue=64, prog_len=16, n_temps=8, sink_buffer=16,
              superstep=3, dlq_slots=8, exchange_slots=0).validate()


def test_superstep_round_attribution_is_global():
    """Records of the second superstep carry engine-global emission
    rounds (base + round within the superstep), as in ``repro``."""
    out = []
    for Cfg, Reg, create, kw in ((JCfg, JReg, j_create, {}),
                                 (EngineConfig, Registry, create_engine,
                                  {"device": "cpu"})):
        reg = Reg.with_capacity(_chain_cfg(Cfg))
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        b = reg.create_composite(t, "b", ["v"], [a], {"v": "in0.v + 1"})
        c = reg.create_composite(t, "c", ["v"], [b], {"v": "in0.v * 2"})
        eng = create(reg, **kw)
        eng.post(a, [1.0], ts=1)
        r1 = eng.latency_records(eng.superstep(3))
        eng.post(a, [2.0], ts=2)                 # stamped its = 3
        r2 = eng.latency_records(eng.superstep(3))
        out.append((r1, r2))
        if create is create_engine:
            assert dict(zip(r1["sid"].tolist(), r1["round"].tolist())) == \
                {b.sid: 0, c.sid: 1}
            assert dict(zip(r2["sid"].tolist(), r2["round"].tolist())) == \
                {b.sid: 3, c.sid: 4}
            assert np.all(r2["its"] == 3)
            assert sorted(r2["latency"].tolist()) == [0, 1]
    for x, y in zip(out[0], out[1]):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_trace_and_slo_tracker_match_jax():
    """The copied trace gives the same schedule from the same config, and
    the copied tracker the same histograms, report and weights."""
    cfg = dict(n_devices=9, rounds=20, seed=5, burst_prob=0.2)
    for (kj, dj, vj), (kp, dp, vp) in zip(
            JWL.SensorTrace(JWL.TraceConfig(**cfg)).steps(),
            PWL.SensorTrace(PWL.TraceConfig(**cfg)).steps()):
        assert kj == kp
        np.testing.assert_array_equal(dj, dp)
        np.testing.assert_array_equal(vj.view(np.int32), vp.view(np.int32))
    rng = np.random.default_rng(0)
    tj = JSLO(5, n_buckets=16, bucket_width=2, slo={1: 3, 2: 0})
    tp = SLOTracker(5, n_buckets=16, bucket_width=2, slo={1: 3, 2: 0})
    for _ in range(4):
        recs = {"tenant": rng.integers(-1, 6, 50),
                "latency": rng.integers(0, 40, 50)}
        assert tj.observe(recs) == tp.observe(recs)
    np.testing.assert_array_equal(tj.hist, tp.hist)
    assert tj.slo_report() == tp.slo_report()
    np.testing.assert_array_equal(j_weights(tj, boost=5),
                                  weights_from_slo(tp, boost=5))


class _StubBatcher:
    """The batcher surface ``wire_pred`` and ``drive`` touch: every
    request completes at the next ``run_ticks`` with its prompt echoed."""

    class cfg:
        vocab = 64

    def __init__(self):
        self.queue = []

    def submit(self, req):
        self.queue.append(req)

    def run_ticks(self, n):
        done, self.queue = self.queue, []
        for r in done:
            r.output, r.done = list(r.prompt), True
        return done


def test_unported_workload_planes_raise():
    """PRED flows (raising until the serving slice) build, wire and
    drive; the autoscaler observes every trace superstep's boundary."""
    pred = PWL.build_suite(3, kinds=("etl", "pred"),
                           trace=PWL.TraceConfig(n_devices=3, rounds=6,
                                                 seed=3, base_rate=0.9),
                           device="cpu")
    assert [f.kind for f in pred.flows] == ["etl", "pred", "etl"]
    bridge = wire_pred(pred, _StubBatcher())
    assert pred.bridge is bridge
    assert set(bridge.routes) == {pred.flows[1].model.sid}
    out = PWL.drive(pred)
    assert out["records"] > 0 and bridge.completed and not bridge.inflight
    resp = pred.flows[1].response
    assert pred.engine.ts_of(resp) > 0          # a completion posted back
    suite = PWL.build_suite(2, trace=PWL.TraceConfig(n_devices=2, rounds=1),
                            device="cpu")
    # the autoscaler (raising until the elastic plane was ported) observes
    # every trace superstep's boundary
    from repro_torch.launch import Autoscaler
    scaler = Autoscaler(suite.engine, min_shards=1, max_shards=1)
    PWL.drive(suite, scaler=scaler)
    assert scaler._steps == 1 and scaler.events == []
    reg = Registry(EngineConfig(n_streams=8))
    flow = PWL.build_pred(reg, reg.create_tenant("t"))
    assert flow.kind == "pred" and flow.model.model_backed
    assert flow.sink.inputs == [flow.response.sid]


# --------------------------------------------------------------------------
# PRED flows through a real batcher, both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pred_model():
    """gemma3-1b SMOKE (vocab 128) weights in both packages and one
    jitted ``repro`` decode shared by its batchers."""
    jcfg = dataclasses.replace(JC.get_smoke("gemma3-1b"), vocab=128)
    pcfg = dataclasses.replace(PC.get_smoke("gemma3-1b"), vocab=128)
    jp = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(3))
    return (jcfg, pcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp)),
            jax.jit(JM.make_decode_step(jcfg)))


def _gap_recording(batcher, jdecode, gaps):
    """``jdecode`` recording the top-2 logit gap of every slot that emits
    a token at the tick (greedy tokens are exact only without ties)."""
    def decode(params, caches, batch, pos):
        logits, caches = jdecode(params, caches, batch, pos)
        lg = np.asarray(logits[:, 0], np.float32)
        pending = getattr(batcher, "_pending_prompt", {})
        for s, req in enumerate(batcher.live):
            if req is not None and not pending.get(s):
                top = np.sort(lg[s])[-2:]
                gaps.append(float(top[1] - top[0]))
        return logits, caches
    return decode


def _pred_suite(pkg, n_shards, pred_model, gaps=None):
    jcfg, pcfg, jp, pp, jdecode = pred_model
    if pkg is JWL:
        batcher = JBatcher(jcfg, jp, slots=2, max_len=64)
        batcher._decode = _gap_recording(batcher, jdecode, gaps)
        wire = JWL.runner.wire_pred
    else:
        batcher = PBatcher(pcfg, pp, slots=2, max_len=64, device="cpu")
        wire = wire_pred
    suite = pkg.build_suite(
        6, n_shards=n_shards,
        trace=pkg.TraceConfig(n_devices=6, rounds=6, seed=4),
        cfg_overrides={"superstep": 3},
        **({"device": "cpu"} if pkg is PWL else {}))
    wire(suite, batcher)
    return suite, pkg.drive(suite, 3)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_pred_suite_matches_repro(n_shards, pred_model):
    gaps = []
    sj, rj = _pred_suite(JWL, n_shards, pred_model, gaps)
    assert gaps and min(gaps) > 1e-4, f"reference top-2 gap {min(gaps)}"
    sp, rp = _pred_suite(PWL, n_shards, pred_model)
    assert [f.kind for f in sp.flows] == ["etl", "stats", "pred"] * 2
    assert rp["records"] == rj["records"] > 0
    assert rp["slo_report"] == rj["slo_report"]
    np.testing.assert_array_equal(sp.slo.hist, sj.slo.hist)
    np.testing.assert_array_equal(sp.slo.violations, sj.slo.violations)
    for k in rj["aggregates"]:
        np.testing.assert_array_equal(_bits(rp["aggregates"][k]),
                                      _bits(rj["aggregates"][k]), err_msg=k)
    done_j = [(r.rid, [int(t) for t in r.prompt], r.output)
              for r in sj.bridge.completed]
    done_p = [(r.rid, [int(t) for t in r.prompt], r.output)
              for r in sp.bridge.completed]
    assert done_p == done_j and len(done_p) > 1
    assert sp.bridge.batcher.ticks == sj.bridge.batcher.ticks
    assert sp.engine.counters() == sj.engine.counters()
    for f in sj.engine.state._fields:
        if f != "stats":
            np.testing.assert_array_equal(
                _bits(getattr(sp.engine.state, f)),
                _bits(getattr(sj.engine.state, f)), err_msg=f)
    for f in (f for f in sp.flows if f.kind == "pred"):
        np.testing.assert_array_equal(_bits(sp.engine.value_of(f.response)),
                                      _bits(sj.engine.value_of(f.response)))
        assert sp.engine.ts_of(f.response) == sj.engine.ts_of(f.response) > 0
