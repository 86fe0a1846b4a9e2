"""Checkpoint-backed self-healing supervisor for the stream engine — the
PyTorch port of the JAX package's ``repro.launch.supervise`` (host Python
only: the engine's rounds are what run on the card).

A driver that owns the run loop, watches every superstep, and composes
the primitives the port already has — atomic checksummed checkpoints with
newest-valid fallback (:mod:`repro_torch.checkpoint.ckpt`), bit-exact
restore (:func:`repro_torch.core.engine.restore_engine`), per-stream fault
counters and the quarantine plane (the circuit breaker) — into a recovery
story:

* **detect** — a superstep that raises (e.g. a chaos
  :class:`~repro_torch.launch.chaos.ShardKill`) is a *crash*; one that
  exceeds ``step_budget_s`` on the host clock is a *stall* (both become
  incidents);
* **restore** — rebuild from the newest *valid* checkpoint (torn/corrupt
  ones are skipped by the checksum plane) with bounded retries under
  exponential backoff, on the failed engine's own ``device``, with its
  ``fanout_fn`` and ``use_kernel``: a CPU engine restores on the CPU, a
  card engine built with ``make_fanout()`` restores with it, a
  plain-version engine restores as one;
* **replay** — re-drive the deterministic feed from the restored step to
  the failure point, so the recovered engine is bit-identical to an
  undisturbed twin;
* **blame** — read the breaker's lifetime ``fault_total`` counters after
  every incident and attribute the failure to the streams that faulted;
* **escalate** — a stream blamed in ``escalate_after`` distinct incidents
  is force-quarantined (the host-triggered trip), so a tenant that keeps
  slipping under the in-window breaker threshold still loses service
  before it takes the run down again;
* **log** — every incident is a structured :class:`Incident` record
  (JSON-able via :meth:`SuperviseReport.to_json`).

The supervisor drives *supersteps*, the same quantum the checkpoint
cadence (``cfg.checkpoint_every``) counts, so "restore + replay" is an
exact prefix-replay — the feed callback must be a pure function of the
step index (post the same SUs for step ``i`` every time it is called).

**What the watchdog times on the card.**  The stall budget times
``_drive`` (the chaos callback, the feed and ``engine.superstep(K)``) on
the host clock.  On a CUDA engine ``superstep(K)`` only stages the ingest
and enqueues the K rounds; it waits for the device only at a checkpoint
boundary, where ``_maybe_checkpoint`` takes a snapshot (a device-to-host
copy).  So a step's wall time is the host's enqueue, plus the device's
backlog on the steps that checkpoint.  It follows that:

* a fault on the device shows up at the next readback, as a crash of a
  later step (the next snapshot, or a readback of the caller's);
* a sticky CUDA error (an illegal address, a device-side assert) leaves
  the process's CUDA context unusable: every restore attempt fails and
  :meth:`Supervisor.run` raises.  The supervisor recovers from failures
  raised on the host — a ``ShardKill``, an exception in the feed or in
  the engine's host code — as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Incident:
    """One detected failure and what recovery did about it."""
    step: int                   # superstep index the failure surfaced at
    kind: str                   # "crash" | "stall"
    detail: str                 # exception repr / stall wall-time
    restored_step: int = -1     # checkpoint step recovery restored (-1: none)
    retries: int = 0            # restore attempts consumed
    replayed_steps: int = 0     # supersteps re-driven after restore
    downtime_s: float = 0.0     # detect -> recovered wall-clock (MTTR term)
    blamed: List[int] = dataclasses.field(default_factory=list)
    escalated: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SuperviseReport:
    """Outcome of one supervised run."""
    steps: int
    incidents: List[Incident]
    recovered: bool             # every incident ended in a live engine
    engine: object = None       # the (possibly rebuilt) engine reference

    @property
    def mttr_s(self) -> float:
        """Mean time to recovery across incidents (0 when none)."""
        if not self.incidents:
            return 0.0
        return float(np.mean([i.downtime_s for i in self.incidents]))

    def to_json(self) -> str:
        return json.dumps({
            "steps": self.steps,
            "recovered": self.recovered,
            "mttr_s": self.mttr_s,
            "incidents": [dataclasses.asdict(i) for i in self.incidents],
        }, indent=2)


class Supervisor:
    """Watchdog + recovery driver around one engine.

    ``feed(engine, step)`` posts step ``step``'s SUs — it must be
    deterministic in ``step`` (replay calls it again for the same index).
    ``chaos(engine, step)`` (optional) runs injections *before* the feed;
    it is NOT called during replay — injected process-death doesn't
    re-occur while recovering from it, but everything the feed posted
    (including poison SUs) is re-posted bit-identically.

    The engine must checkpoint into ``ckpt_path`` (the supervisor attaches
    a manager via ``checkpoint_to(ckpt_path, keep=keep)`` if none is
    attached yet; set ``cfg.checkpoint_every`` to the cadence).  A restore
    re-attaches a manager at ``checkpoint_to``'s default ``keep`` of 3,
    as the JAX package's supervisor does.  The JAX package's ``mesh``
    argument has no counterpart: the restore takes the failed engine's
    ``device``, ``fanout_fn`` and ``use_kernel`` instead."""

    def __init__(self, engine, ckpt_path: str, *,
                 feed: Optional[Callable] = None,
                 chaos: Optional[Callable] = None,
                 K: Optional[int] = None,
                 step_budget_s: float = float("inf"),
                 max_retries: int = 3,
                 backoff0_s: float = 0.05,
                 backoff_mult: float = 2.0,
                 blame_faults: int = 1,
                 escalate_after: int = 2,
                 keep: int = 3):
        self.engine = engine
        self.ckpt_path = ckpt_path
        self.feed = feed
        self.chaos = chaos
        self.K = K or engine.cfg.superstep
        self.step_budget_s = step_budget_s
        self.max_retries = max_retries
        self.backoff0_s = backoff0_s
        self.backoff_mult = backoff_mult
        self.blame_faults = blame_faults
        self.escalate_after = escalate_after
        self.incidents: List[Incident] = []
        self._blame_counts: Dict[int, int] = {}
        if engine._ckpt is None:
            engine.checkpoint_to(ckpt_path, keep=keep)

    # ------------------------------------------------------------ plumbing
    def _drive(self, step: int, *, replay: bool) -> None:
        """One superstep: chaos (live only) -> feed -> the K rounds."""
        if self.chaos is not None and not replay:
            self.chaos(self.engine, step)
        if self.feed is not None:
            self.feed(self.engine, step)
        self.engine.superstep(self.K)

    def _restore(self, inc: Incident) -> None:
        """Bounded-retry restore from the newest valid checkpoint, with
        exponential backoff between attempts, on the failed engine's
        device and with its fan-out and kernel choice.  Raises the last
        error when every attempt fails (the run is then genuinely
        down)."""
        from repro_torch.core.engine import restore_engine
        failed = self.engine
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries):
            inc.retries = attempt + 1
            if attempt:
                time.sleep(self.backoff0_s
                           * self.backoff_mult ** (attempt - 1))
            try:
                eng = restore_engine(self.ckpt_path, device=failed.device,
                                     fanout_fn=failed._fanout_fn,
                                     use_kernel=failed.use_kernel)
            except Exception as e:        # torn dir listing, device loss...
                last = e
                continue
            if eng is None:               # no valid checkpoint at all
                last = RuntimeError(
                    f"no valid checkpoint under {self.ckpt_path}")
                continue
            eng.checkpoint_to(self.ckpt_path)
            self.engine = eng
            inc.restored_step = eng._steps_done
            return
        raise RuntimeError(
            f"recovery failed after {self.max_retries} attempts: {last}"
        ) from last

    def _assign_blame(self, inc: Incident) -> None:
        """Blame the streams whose lifetime fault counters crossed
        ``blame_faults``; force-quarantine any blamed in
        ``escalate_after`` distinct incidents."""
        fc = self.engine.fault_counters()
        blamed = np.nonzero(fc["fault_total"] >= self.blame_faults)[0]
        inc.blamed = [int(s) for s in blamed]
        for sid in inc.blamed:
            n = self._blame_counts.get(sid, 0) + 1
            self._blame_counts[sid] = n
            if n >= self.escalate_after and not bool(fc["quarantined"][sid]):
                self.engine.quarantine(sid)
                inc.escalated.append(sid)

    # ------------------------------------------------------------ run loop
    def step(self, step: int) -> Optional[Incident]:
        """Drive superstep ``step`` under the watchdog.  Returns the
        incident when a failure was detected (and recovered), else None."""
        t0 = time.monotonic()
        try:
            self._drive(step, replay=False)
            wall = time.monotonic() - t0
            if wall <= self.step_budget_s:
                return None
            inc = Incident(step=step, kind="stall",
                           detail=f"superstep took {wall:.3f}s "
                                  f"(budget {self.step_budget_s:.3f}s)")
        except Exception as e:
            inc = Incident(step=step, kind="crash", detail=repr(e))
        # ---- recover: restore newest valid, replay the feed prefix ------
        # log first: a recovery that itself fails must still leave the
        # incident in the audit trail
        self.incidents.append(inc)
        self._restore(inc)
        for s in range(self.engine._steps_done, step + 1):
            self._drive(s, replay=True)
            inc.replayed_steps += 1
        self._assign_blame(inc)
        inc.downtime_s = time.monotonic() - t0
        return inc

    def run(self, n_steps: int, start: int = 0) -> SuperviseReport:
        """Drive ``n_steps`` supervised supersteps.  Every failure is
        recovered in-line; an unrecoverable one (no valid checkpoint,
        retries exhausted) propagates after being logged, with
        ``last_report.recovered`` false."""
        step = start
        try:
            while step < start + n_steps:
                self.step(step)
                step += 1
        except Exception:
            self.last_report = SuperviseReport(
                steps=step - start, incidents=self.incidents,
                recovered=False, engine=self.engine)
            raise
        report = SuperviseReport(steps=n_steps, incidents=self.incidents,
                                 recovered=True, engine=self.engine)
        self.last_report = report
        return report


def supervised_run(engine, ckpt_path: str, n_steps: int, *,
                   feed: Optional[Callable] = None,
                   chaos: Optional[Callable] = None,
                   **kw) -> SuperviseReport:
    """Canonical supervised drive loop (mirror of
    :func:`repro_torch.launch.autoscale.autoscaled_run`): wrap ``engine``
    in a :class:`Supervisor` and run ``n_steps`` supersteps.  The returned
    report's ``engine`` field is the live engine — possibly a *different
    object* than the input if a recovery rebuilt it (same contract as
    ``restore_engine``)."""
    sup = Supervisor(engine, ckpt_path, feed=feed, chaos=chaos, **kw)
    return sup.run(n_steps)
