"""Suite assembly and drive loop for the IoT workloads — the PyTorch port
of the JAX package's ``repro.workloads.runner``.

``build_suite`` wires N tenants — each running one ETL, STATS or PRED
dataflow — onto a single engine with one replayable
:class:`~repro_torch.workloads.traces.SensorTrace` device per tenant, and
``drive`` replays the trace through supersteps while folding every
*terminal-sink* emission into an :class:`~repro_torch.core.slo.SLOTracker`
and every STATS emission into the window store, and pumping PRED
emissions through the serving bridge (``wire_pred``).

Latency semantics: the engine's sink spool carries every external
emission, including intermediate pipeline stages (parse, filter, ...).
End-to-end latency is the terminal stage's, so the runner filters
latency records to each flow's ``sink_sid`` before the tracker sees them
(:func:`sink_records`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import EngineConfig, Registry, create_engine
from repro_torch.core.slo import SLOTracker
from repro_torch.workloads.dataflows import (Dataflow, WindowedStats,
                                             build_etl, build_pred,
                                             build_stats)
from repro_torch.workloads.traces import SensorTrace, TraceConfig

# registry rows a flow of each kind consumes (source + stages [+ response])
_SIDS_PER_KIND = {"etl": 5, "stats": 2, "pred": 5}
_BUILDERS = {"etl": build_etl, "stats": build_stats, "pred": build_pred}


@dataclasses.dataclass
class IoTSuite:
    """One assembled workload: engine + flows + trace + trackers."""
    cfg: EngineConfig
    registry: Registry
    engine: object
    flows: List[Dataflow]
    trace: SensorTrace
    slo: SLOTracker
    stats: Optional[WindowedStats]          # fed from STATS sinks only
    bridge: object = None                   # serving bridge for PRED flows

    @property
    def sink_sids(self) -> np.ndarray:
        return np.asarray([f.sink_sid for f in self.flows], np.int32)


def sink_records(records: Dict[str, np.ndarray],
                 sink_sids) -> Dict[str, np.ndarray]:
    """Restrict a ``latency_records`` batch to terminal-sink emissions —
    the records whose latency is a pipeline's end-to-end number."""
    keep = np.isin(np.asarray(records["sid"]), np.asarray(sink_sids))
    return {k: np.asarray(v)[keep] for k, v in records.items()}


def build_suite(n_tenants: int = 12, *,
                kinds: Sequence[str] = ("etl", "stats", "pred"),
                n_shards: int = 1,
                trace: Optional[TraceConfig] = None,
                slo_rounds: Optional[int] = 16,
                window: int = 8,
                batch: int = 16, queue: int = 256,
                fused_round: Optional[bool] = None,
                cfg_overrides: Optional[Dict] = None,
                device="cuda", use_kernel: Optional[bool] = None
                ) -> IoTSuite:
    """Assemble one engine on ``device`` (sharded when ``n_shards > 1``)
    running ``n_tenants`` IoT pipelines, kinds assigned round-robin from
    ``kinds``; tenant ``t`` owns trace device ``t``.  ``slo_rounds`` (None to disable) is every
    tenant's latency target; ``fused_round`` pins the engine's
    fused/staged round path (None = config default).  ``use_kernel`` goes
    to the engine and the window plane (``False``: the kernels' plain
    versions on any device)."""
    kinds = [kinds[i % len(kinds)] for i in range(n_tenants)]
    n_streams = sum(_SIDS_PER_KIND[k] for k in kinds) + 2
    n_streams = -(-n_streams // n_shards) * n_shards   # pad to shard multiple
    over = dict(cfg_overrides or {})
    if fused_round is not None:
        over["fused_round"] = fused_round
    over.setdefault("superstep", 4)
    cfg = EngineConfig(
        n_streams=n_streams, n_tenants=n_tenants + 1, batch=batch,
        queue=queue, max_in=2, max_out=2, prog_len=24, n_temps=12,
        n_shards=n_shards, exchange_slots=0, **over)
    reg = Registry.with_capacity(cfg, max_streams=n_streams)
    flows: List[Dataflow] = []
    for t, kind in enumerate(kinds):
        tenant = reg.create_tenant(f"tenant{t}", quota_streams=10 ** 9)
        flows.append(_BUILDERS[kind](reg, tenant, prefix=f"t{t}.{kind}"))
    engine = create_engine(reg, device=device, use_kernel=use_kernel)
    slo = SLOTracker(n_tenants + 1,
                     slo=None if slo_rounds is None
                     else {f.tenant.tid: slo_rounds for f in flows})
    has_stats = any(f.kind == "stats" for f in flows)
    stats = WindowedStats(n_streams, window=window, channels=cfg.channels,
                          device=engine.device, use_kernel=use_kernel) \
        if has_stats else None
    tcfg = trace or TraceConfig(n_devices=n_tenants)
    if tcfg.n_devices != n_tenants:
        tcfg = dataclasses.replace(tcfg, n_devices=n_tenants)
    return IoTSuite(cfg, reg, engine, flows, SensorTrace(tcfg), slo, stats)


def wire_pred(suite: IoTSuite, batcher, *, watermark: Optional[int] = None,
              prompt_len: int = 4):
    """Attach a serving bridge for the suite's PRED flows.  ``batcher``
    is a :class:`repro_torch.serving.ContinuousBatcher` (or any object
    with its ``submit``/``run_ticks``/``cfg.vocab`` surface — tests pass a
    stub).  Returns the bridge (also stored on the suite)."""
    from repro_torch.serving.bridge import ModelBackedStreams
    bridge = ModelBackedStreams(suite.engine, batcher, watermark)
    for f in suite.flows:
        if f.kind == "pred":
            bridge.route(f.model, f.response, prompt_len)
    suite.bridge = bridge
    return bridge


def _pump(suite: IoTSuite, spool, ts: int) -> None:
    """The serving bridge's turn after a superstep: re-try deferred
    emissions, submit the spool's model-backed emissions, decode until
    the batcher is idle and post the completions back."""
    if suite.bridge is not None:
        suite.bridge.release_deferred()
        suite.bridge.pump_spool(spool, ts=ts)
        suite.bridge.drain(ts=ts)


def _observe(suite: IoTSuite, sinks, sink_sids) -> int:
    """Fold one superstep's per-round sinks into the SLO tracker."""
    recs = suite.engine.latency_records(sinks)
    return suite.slo.observe(sink_records(recs, sink_sids))


def drive(suite: IoTSuite, K: int = 4, *, scaler=None,
          stats_sids: Optional[np.ndarray] = None) -> Dict:
    """Replay the suite's trace: each trace round posts its emissions,
    runs one K-round superstep, folds terminal-sink latency records into
    the SLO tracker, pushes STATS emissions into the window store and
    pumps the serving bridge (stamp-preserving, so PRED completions land
    in later supersteps with their original ingest round); four more
    supersteps let in-flight SUs and PRED responses reach their sinks.
    With a bridge each superstep's spool is read back twice (the sinks,
    then the bridge's pump), else once.  ``scaler`` (a
    :class:`repro_torch.launch.autoscale.Autoscaler`) observes every
    trace superstep's boundary.  Returns ``{"records": n, "slo_report":
    ..., "aggregates": ...}`` (aggregates as host arrays)."""
    eng = suite.engine
    sink_sids = suite.sink_sids
    if stats_sids is None:
        stats_sids = np.asarray(
            [f.sink_sid for f in suite.flows if f.kind == "stats"], np.int32)
    n_obs = 0
    for k, dev, vals in suite.trace.steps():
        for d, v in zip(dev, vals):
            eng.post(suite.flows[d].source, [float(v)], ts=k + 1)
        spool = eng.superstep(K)
        sinks = eng.spool_sinks(spool)
        n_obs += _observe(suite, sinks, sink_sids)
        if suite.stats is not None and stats_sids.size:
            suite.stats.push_sinks([
                s._replace(valid=np.isin(s.sid, stats_sids) & s.valid)
                for s in sinks])
        _pump(suite, spool, 1000 + k)
        if scaler is not None:
            scaler.observe()
    # let in-flight SUs (and PRED responses) reach their sinks
    for k in range(4):
        spool = eng.superstep(K)
        n_obs += _observe(suite, eng.spool_sinks(spool), sink_sids)
        _pump(suite, spool, 2000 + k)
    return {
        "records": n_obs,
        "slo_report": suite.slo.slo_report(),
        "aggregates": None if suite.stats is None
        else {k: v.cpu().numpy() for k, v in suite.stats.aggregates().items()},
    }
