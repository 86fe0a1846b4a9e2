"""IoT application workloads (RIoTBench-style) for the port's engine:
the ETL, STATS and PRED dataflows, the replayable sensor trace and the
suite runner that drives them through supersteps (the PyTorch port of
the JAX package's ``repro.workloads``).

* :func:`~repro_torch.workloads.dataflows.build_etl`   — parse →
  range-filter → interpolate → annotate.
* :func:`~repro_torch.workloads.dataflows.build_stats` — smoothing
  composite feeding windowed aggregates (:mod:`repro_torch.core.windows`).
* :func:`~repro_torch.workloads.dataflows.build_pred`  — feature
  composite → model-backed stream → response → decision, served through
  the serving bridge (:func:`~repro_torch.workloads.runner.wire_pred`).
* :class:`~repro_torch.workloads.traces.SensorTrace`   — replayable
  per-device emission schedule (diurnal sinusoid x random bursts x value
  walk).
* :func:`~repro_torch.workloads.runner.build_suite` /
  :func:`~repro_torch.workloads.runner.drive` — wire N tenants' flows
  onto one engine and replay a trace through supersteps, folding every
  sink record into an :class:`~repro_torch.core.slo.SLOTracker`.
"""
from repro_torch.workloads.dataflows import (Dataflow, WindowedStats,
                                             build_etl, build_pred,
                                             build_stats)
from repro_torch.workloads.runner import (IoTSuite, build_suite, drive,
                                          wire_pred)
from repro_torch.workloads.traces import SensorTrace, TraceConfig

__all__ = [
    "Dataflow", "WindowedStats", "build_etl", "build_pred", "build_stats",
    "IoTSuite", "build_suite", "drive", "wire_pred", "SensorTrace",
    "TraceConfig",
]
