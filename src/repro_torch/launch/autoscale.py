"""Host-side autoscaling policy loop for the elastic stream mesh — the
PyTorch port of the JAX package's ``repro.launch.autoscale`` (host Python
only: the engine's rounds are what run on the card).

The elastic primitive (``StreamEngine.resize``) moves the pub/sub plane
between shard counts at superstep boundaries; this module closes the loop
with the *policy*: an :class:`Autoscaler` that watches the engine's own
backlog/occupancy/drop counters after every superstep and grows or shrinks
the mesh under hysteresis — live, with no restart and no lost SU.

Signals (host readbacks of state the engine already keeps):

* **occupancy** — total queued SUs (``tenant_backlog().sum()``) over total
  queue capacity (``n_shards * cfg.queue``).  The leading indicator:
  rising occupancy means the mesh pops fewer SUs per round than tenants
  ingest.
* **drops** — the ``dropped_overflow`` delta since the last observation.
  The lagging indicator: nonzero means the backlog already overflowed
  somewhere (queue or exchange) and SUs are dead-lettering.

Policy (hysteresis beats cleverness here):

* scale **up** (double, capped at ``max_shards``) after ``patience``
  consecutive observations with occupancy >= ``up`` — or immediately on
  new overflow drops (or an SLO violation rate over ``slo_up``);
* scale **down** (halve, floored at ``min_shards``) after ``patience``
  consecutive observations with occupancy <= ``down``;
* after any resize, ignore ``cooldown`` observations so the new mesh's
  steady state lands before the next decision — the flap guard.

Use :func:`autoscaled_run` for the canonical drive loop, or call
:meth:`Autoscaler.observe` yourself after each superstep.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ScaleEvent:
    """One autoscaler decision, for logs and benchmarks."""
    step: int                   # observation index the decision landed on
    from_shards: int
    to_shards: int
    occupancy: float            # fractional queue occupancy that triggered it
    drops: int                  # overflow-drop delta that triggered it
    reason: str                 # "backlog" | "drops" | "slo" | "idle"


class Autoscaler:
    """Hysteresis-driven shard-count controller around one engine.

    The engine reference stays valid across resizes — ``resize`` morphs
    the engine in place — so one Autoscaler can drive an engine through
    any number of scale events.  ``observe()`` reads two counters back
    and must be called at superstep boundaries only: that is the only
    point the elastic plane may resize."""

    def __init__(self, engine, *, min_shards: int = 1, max_shards: int = 4,
                 up: float = 0.5, down: float = 0.15, patience: int = 2,
                 cooldown: int = 4, slo=None, slo_up: float = 0.05):
        if not (1 <= min_shards <= max_shards):
            raise ValueError(
                f"need 1 <= min_shards <= max_shards, got "
                f"{min_shards}..{max_shards}")
        if not (0.0 <= down < up <= 1.0):
            raise ValueError(f"need 0 <= down < up <= 1, got "
                             f"down={down}, up={up}")
        self.engine = engine
        self.min_shards = int(min_shards)
        self.max_shards = int(max_shards)
        self.up = float(up)
        self.down = float(down)
        self.patience = max(1, int(patience))
        self.cooldown = max(0, int(cooldown))
        # optional latency signal: a repro_torch.core.slo.SLOTracker the
        # caller feeds latency records into; an observation window whose
        # SLO violation rate exceeds `slo_up` scales up like fresh drops
        self.slo = slo
        self.slo_up = float(slo_up)
        self.events: List[ScaleEvent] = []
        self._steps = 0
        self._hot = 0               # consecutive observations over `up`
        self._cold = 0              # consecutive observations under `down`
        self._hold = 0              # cooldown observations left
        self._last_drops = self._drop_total()
        self._last_viol, self._last_obs = self._viol_totals()

    # ------------------------------------------------------------- signals
    def _drop_total(self) -> int:
        return int(self.engine.counters()["dropped_overflow"])

    def _viol_totals(self):
        if self.slo is None:
            return 0, 0
        return (int(self.slo.violations.sum()), int(self.slo.hist.sum()))

    def occupancy(self) -> float:
        """Fraction of total queue capacity currently backlogged."""
        backlog = int(np.asarray(self.engine.tenant_backlog()).sum())
        cap = self.engine.cfg.n_shards * self.engine.cfg.queue
        return backlog / cap if cap else 0.0

    # -------------------------------------------------------------- policy
    def observe(self) -> Optional[ScaleEvent]:
        """Feed one superstep boundary to the controller; resizes the
        engine (in place) when the hysteresis gates open.  Returns the
        :class:`ScaleEvent` when a resize happened, else None."""
        self._steps += 1
        occ = self.occupancy()
        drops_now = self._drop_total()
        d_drops = drops_now - self._last_drops
        self._last_drops = drops_now
        viol_now, obs_now = self._viol_totals()
        d_viol, d_obs = viol_now - self._last_viol, obs_now - self._last_obs
        self._last_viol, self._last_obs = viol_now, obs_now
        slo_hot = d_obs > 0 and d_viol / d_obs > self.slo_up
        if self._hold > 0:
            self._hold -= 1
            return None
        self._hot = self._hot + 1 if occ >= self.up else 0
        self._cold = self._cold + 1 if occ <= self.down else 0
        n = self.engine.cfg.n_shards
        if (d_drops > 0 or slo_hot or self._hot >= self.patience) \
                and n < self.max_shards:
            return self._resize(min(n * 2, self.max_shards), occ, d_drops,
                                "drops" if d_drops > 0
                                else "slo" if slo_hot else "backlog")
        if self._cold >= self.patience and n > self.min_shards:
            return self._resize(max(n // 2, self.min_shards), occ, d_drops,
                                "idle")
        return None

    def _resize(self, to: int, occ: float, drops: int,
                reason: str) -> ScaleEvent:
        ev = ScaleEvent(step=self._steps,
                        from_shards=self.engine.cfg.n_shards, to_shards=to,
                        occupancy=occ, drops=drops, reason=reason)
        self.engine.resize(to)
        self.events.append(ev)
        self._hot = self._cold = 0
        self._hold = self.cooldown
        return ev


def autoscaled_run(engine, feed, K: int, *, scaler: Optional[Autoscaler]
                   = None, **scaler_kw):
    """Drive ``engine`` through supersteps with the autoscaler in the loop:
    each iteration calls ``feed(engine, step_index)`` to post that step's
    ingest, runs one K-round superstep, then lets the scaler observe (and
    possibly resize).  ``feed`` returning False ends the run.  Returns the
    :class:`Autoscaler` (its ``events`` list is the scaling history)."""
    if scaler is None:
        scaler = Autoscaler(engine, **scaler_kw)
    step = 0
    while feed(engine, step) is not False:
        engine.superstep(K)
        scaler.observe()
        step += 1
    return scaler
