"""RIoTBench-style dataflow builders over the pub/sub registry — the
PyTorch port of the JAX package's ``repro.workloads.dataflows``.

Each builder installs one tenant's pipeline as registry streams *before*
engine creation (the benchmark shape: topology is static, tables are
data), and returns a :class:`Dataflow` handle naming the source the
trace feeds and the terminal sink whose emissions carry the pipeline's
end-to-end ingest→sink latency:

* **ETL** — ``parse → range-filter → interpolate → annotate``: linear
  calibration, out-of-range rejection (a ``pre_filter``), smoothing
  against the previous emission (``prev.<ch>``), and a derived alert
  channel.  Every op is VM-fusable, so the fused and staged engine paths
  must agree bitwise.
* **STATS** — a smoothing composite whose emissions the host folds into
  a :class:`~repro_torch.core.windows.WindowStore`; windowed
  sum/mean/max/min ride the ``window_agg`` kernel via
  :meth:`WindowedStats.aggregates`.
* **PRED** — a feature composite feeding a *model-backed* stream; the
  serving bridge turns its emissions into LM requests and posts scores
  back on the response stream (stamp-preserving, so PRED latency
  includes decode time), where a decision composite consumes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.windows import (WindowStore, aggregate,
                                      init_window_store, push)


@dataclasses.dataclass
class Dataflow:
    """One tenant's installed pipeline: feed ``source``, measure at
    ``sink`` (for PRED the sink is the decision stage downstream of the
    serving response, so its latency spans the full loop)."""
    kind: str                   # "etl" | "stats" | "pred"
    tenant: object              # registry Tenant
    source: object              # device-fed Stream the trace posts into
    stages: List[object]        # all composite Streams, source-to-sink
    sink: object                # terminal Stream carrying e2e latency
    model: Optional[object] = None      # PRED: the model-backed Stream
    response: Optional[object] = None   # PRED: the bridge response Stream

    @property
    def sink_sid(self) -> int:
        return self.sink.sid


def build_etl(reg, tenant, prefix: str = "etl") -> Dataflow:
    """parse → range-filter → interpolate → annotate (RIoTBench ETL)."""
    raw = reg.create_stream(tenant, f"{prefix}.raw", ["v"])
    # linear sensor calibration (raw counts -> engineering units)
    parse = reg.create_composite(
        tenant, f"{prefix}.parse", ["v"], [raw], {"v": "in0.v * 0.5"})
    # range filter: reject implausible readings before they propagate
    rfilter = reg.create_composite(
        tenant, f"{prefix}.filter", ["v"], [parse], {"v": "in0.v"},
        pre_filter="in0.v > -15.0 && in0.v < 35.0")
    # interpolate: smooth against this stream's previous emission
    interp = reg.create_composite(
        tenant, f"{prefix}.interp", ["v"], [rfilter],
        {"v": "(in0.v + prev.v) * 0.5"})
    # annotate: derived alert channel rides along with the reading
    annot = reg.create_composite(
        tenant, f"{prefix}.annot", ["v", "alert"], [interp],
        {"v": "in0.v", "alert": "in0.v > 25.0 ? 1.0 : 0.0"})
    return Dataflow("etl", tenant, raw, [parse, rfilter, interp, annot],
                    annot)


def build_stats(reg, tenant, prefix: str = "stats") -> Dataflow:
    """Smoothing composite feeding windowed aggregation: one spike-guarded
    smoothing stage on the engine; the window lives in a
    :class:`WindowedStats` the runner feeds from this flow's sink
    emissions."""
    raw = reg.create_stream(tenant, f"{prefix}.raw", ["v"])
    clean = reg.create_composite(
        tenant, f"{prefix}.clean", ["v"], [raw],
        {"v": "(in0.v + prev.v) * 0.5"},
        pre_filter="in0.v > -40.0 && in0.v < 80.0")
    return Dataflow("stats", tenant, raw, [clean], clean)


def build_pred(reg, tenant, prefix: str = "pred") -> Dataflow:
    """Feature composite → model-backed stream → response → decision.

    The model-backed stream and its response must be wired onto a
    serving bridge after engine creation: ``bridge.route(flow.model,
    flow.response)`` (:func:`repro_torch.workloads.runner.wire_pred`)."""
    raw = reg.create_stream(tenant, f"{prefix}.raw", ["v"])
    feat = reg.create_composite(
        tenant, f"{prefix}.feat", ["v"], [raw], {"v": "in0.v * 0.05"})
    model = reg.create_composite(
        tenant, f"{prefix}.model", ["req"], [feat], {}, model_backed=True)
    resp = reg.create_stream(tenant, f"{prefix}.resp", ["score"])
    decide = reg.create_composite(
        tenant, f"{prefix}.decide", ["hit"], [resp],
        {"hit": "in0.score > 0.5 ? 1.0 : 0.0"})
    return Dataflow("pred", tenant, raw, [feat, model, decide], decide,
                    model=model, response=resp)


class WindowedStats:
    """Window plane for STATS flows: fold sink emissions into a
    :class:`WindowStore` on ``device`` and answer windowed aggregates
    through the ``window_agg`` kernel (its plain version on the CPU, or
    anywhere with ``use_kernel=False``).

    ``push`` takes at most one SU per stream per call (the WindowStore
    contract); per-round :class:`SinkBatch` views satisfy that by
    construction, so a superstep's sinks (``engine.spool_sinks``) are
    folded round by round."""

    def __init__(self, n_streams: int, window: int = 8, channels: int = 1,
                 device="cuda", use_kernel: Optional[bool] = None):
        self.window = int(window)
        self.use_kernel = use_kernel
        self.store: WindowStore = init_window_store(
            int(n_streams), self.window, int(channels), device=device)

    def push_sinks(self, sinks: Sequence) -> None:
        """Fold per-round :class:`SinkBatch` es (host arrays, in round
        order) into the window: one host->device copy per plane for all of
        them, then one ring insert per round."""
        if not sinks:
            return
        dev = self.store.values.device
        C = self.store.values.shape[-1]

        def ship(field, dtype):
            a = np.stack([np.asarray(getattr(s, field)) for s in sinks])
            return torch.from_numpy(a.astype(dtype, copy=False)).to(dev)

        sid, ts = ship("sid", np.int32), ship("ts", np.int32)
        vals, valid = ship("vals", np.float32), ship("valid", bool)
        for k in range(len(sinks)):
            self.store = push(self.store, sid[k], vals[k, :, :C], ts[k],
                              valid[k])

    def aggregates(self, horizon: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
        """Windowed sum/mean/max/min/count per stream, (N, C) each."""
        return aggregate(self.store, horizon=horizon,
                         use_kernel=self.use_kernel)
