"""Per-tenant end-to-end latency SLO tracking — the host half of the
ingest-timestamp plane (a copy of the JAX package's ``repro.core.slo``,
host numpy only).

The device side stamps every Sensor Update with the engine round it was
posted in (``IngestBatch.its``) and carries the stamp through the whole
SU lifecycle; :meth:`StreamEngine.latency_records` reads it back at the
sink spool as per-record ingest→sink latency in *rounds* (one round is
the engine's scheduling quantum, so latency-in-rounds is the unit the
QoS and elastic planes actually control).  :class:`SLOTracker`
aggregates those records into per-tenant latency histograms and answers
the questions production asks: what are a tenant's p50/p95/p99, which
tenants are violating their SLO, and at what rate.

Histogram shape: ``n_buckets`` fixed-width buckets of ``bucket_width``
rounds each; a latency lands in bucket ``min(latency // bucket_width,
n_buckets - 1)`` (the last bucket absorbs overflow).  With the defaults
(256 x 1) percentiles are *exact* up to 255 rounds — far beyond any
healthy pipeline depth — at 1KB per tenant.  Widen ``bucket_width``
(keeping percentile error <= width-1 rounds) rather than adding buckets
when tracking very deep pipelines; see docs/OPERATIONS.md.

Percentile semantics are nearest-rank: ``percentile(q)`` is the upper
bound of the first bucket whose cumulative count reaches ``ceil(q/100 *
count)`` — the smallest latency L such that at least q% of records have
latency <= L (bucket-resolution; exact at width 1).  Empty histograms
report -1.

Hookups: :meth:`SLOTracker.pressure` is the per-tenant violation-rate
vector the autoscaler can treat as a scale-up signal, and
:func:`weights_from_slo` turns it into a fair-share weight table for
``engine.set_weight`` — tenants missing their SLO get service
proportional to how badly they miss it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SLOTracker:
    """Accumulate :meth:`StreamEngine.latency_records` output into
    per-tenant latency histograms with optional SLO targets.

    ``slo`` maps tenant id -> max acceptable ingest→sink latency in
    rounds (records above it count as violations); tenants without a
    target never violate.  All state is host-side numpy — observing
    records never touches the device.
    """

    def __init__(self, n_tenants: int, *, n_buckets: int = 256,
                 bucket_width: int = 1,
                 slo: Optional[Dict[int, int]] = None):
        if n_buckets < 2 or bucket_width < 1:
            raise ValueError(
                f"need n_buckets >= 2 and bucket_width >= 1, got "
                f"{n_buckets} x {bucket_width}")
        self.n_tenants = int(n_tenants)
        self.n_buckets = int(n_buckets)
        self.bucket_width = int(bucket_width)
        self.hist = np.zeros((self.n_tenants, self.n_buckets), np.int64)
        self.violations = np.zeros((self.n_tenants,), np.int64)
        self._slo = np.full((self.n_tenants,), -1, np.int64)   # -1: no target
        for tid, target in (slo or {}).items():
            self.set_slo(tid, target)

    # -------------------------------------------------------------- intake
    def set_slo(self, tenant, max_latency: Optional[int]) -> None:
        """Set (or clear, with ``None``) one tenant's latency target in
        rounds.  Applies to records observed afterwards only — violation
        counts are not rebinned."""
        tid = tenant.tid if hasattr(tenant, "tid") else int(tenant)
        self._slo[tid] = -1 if max_latency is None else int(max_latency)

    def slo_of(self, tenant) -> Optional[int]:
        tid = tenant.tid if hasattr(tenant, "tid") else int(tenant)
        t = int(self._slo[tid])
        return None if t < 0 else t

    def observe(self, records: Dict[str, np.ndarray]) -> int:
        """Fold one :meth:`StreamEngine.latency_records` batch in;
        returns the number of records absorbed.  Records whose tenant is
        unresolved (-1) are dropped — a sink row whose stream was revoked
        between emission and readback has no owner to bill."""
        tenant = np.asarray(records["tenant"], np.int64)
        latency = np.asarray(records["latency"], np.int64)
        ok = (tenant >= 0) & (tenant < self.n_tenants)
        tenant, latency = tenant[ok], latency[ok]
        if tenant.size == 0:
            return 0
        bucket = np.minimum(latency // self.bucket_width, self.n_buckets - 1)
        np.add.at(self.hist, (tenant, bucket), 1)
        target = self._slo[tenant]
        np.add.at(self.violations, tenant[(target >= 0) & (latency > target)],
                  1)
        return int(tenant.size)

    def reset(self) -> None:
        """Zero the histograms and violation counts (SLO targets stay)."""
        self.hist[:] = 0
        self.violations[:] = 0

    # ------------------------------------------------------------ readback
    def count(self, tenant=None) -> int:
        h = self.hist if tenant is None \
            else self.hist[tenant.tid if hasattr(tenant, "tid")
                           else int(tenant)]
        return int(h.sum())

    def percentile(self, q: float, tenant=None) -> int:
        """Nearest-rank percentile in rounds (bucket upper bound; exact
        at ``bucket_width=1``); -1 when no records were observed."""
        h = self.hist.sum(axis=0) if tenant is None \
            else self.hist[tenant.tid if hasattr(tenant, "tid")
                           else int(tenant)]
        total = int(h.sum())
        if total == 0:
            return -1
        rank = max(1, int(np.ceil(q / 100.0 * total)))
        bucket = int(np.searchsorted(np.cumsum(h), rank, side="left"))
        return (bucket + 1) * self.bucket_width - 1

    def pressure(self) -> np.ndarray:
        """Per-tenant SLO violation rate in [0, 1] — the signal the
        autoscaler treats like drops and :func:`weights_from_slo` turns
        into fair-share weights.  Tenants with no records report 0."""
        counts = self.hist.sum(axis=1)
        return np.divide(self.violations, counts,
                         out=np.zeros((self.n_tenants,), np.float64),
                         where=counts > 0)

    def slo_report(self) -> Dict:
        """The operator-facing summary: per-tenant count / p50 / p95 /
        p99 / SLO target / violations / violation rate, plus the same
        aggregated over all tenants under ``"total"``.  Tenants with no
        observed records are omitted from ``"tenants"``."""
        counts = self.hist.sum(axis=1)
        report: Dict = {"tenants": {}}
        for tid in np.nonzero(counts)[0]:
            tid = int(tid)
            n = int(counts[tid])
            report["tenants"][tid] = {
                "count": n,
                "p50": self.percentile(50, tid),
                "p95": self.percentile(95, tid),
                "p99": self.percentile(99, tid),
                "slo": self.slo_of(tid),
                "violations": int(self.violations[tid]),
                "violation_rate": int(self.violations[tid]) / n,
            }
        total = int(counts.sum())
        viol = int(self.violations.sum())
        report["total"] = {
            "count": total,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "violations": viol,
            "violation_rate": viol / total if total else 0.0,
        }
        return report


def weights_from_slo(tracker: SLOTracker, *, base: int = 0,
                     boost: int = 8) -> np.ndarray:
    """Map SLO pressure to fair-share weights: every tenant starts at
    ``base`` (0 = unshaped, the engine default) and violating tenants
    get up to ``base + boost`` proportional to their violation rate.
    Apply with ``engine.set_weight(tid, w)`` per changed tenant — each
    is one in-place table edit."""
    p = tracker.pressure()
    return (base + np.rint(p * boost)).astype(np.int64)
