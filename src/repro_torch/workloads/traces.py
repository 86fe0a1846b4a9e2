"""Synthetic sensor-trace generator with diurnal ramps and bursts.

Real IoT feeds (the RIoTBench taxi/SenML traces, smart-grid meters) share
three statistical signatures the benchmark must reproduce to stress the
engine the way the paper's STORM deployment was stressed:

* a **diurnal envelope** — fleet-wide emission rate swings sinusoidally
  over a simulated day, so shard pressure ramps rather than steps;
* **per-device bursts** — individual devices occasionally fire at a
  multiple of their base rate for a few rounds (a stuck sensor, a
  threshold alarm), which is what skews per-tenant tail latency;
* a **value random walk** — readings are autocorrelated, so smoothing /
  interpolation stages see realistic inputs rather than white noise.

Everything is driven by one seeded :class:`numpy.random.Generator`, so a
trace is a pure function of its :class:`TraceConfig` — replaying the same
config yields bit-identical emission schedules, which the differential
tests (fused vs staged, 1 vs N shards) rely on.  The generator is
host-side numpy only (a copy of the JAX package's
``repro.workloads.traces``: the same config gives the same trace in both).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for one replayable sensor trace."""
    n_devices: int = 64             # distinct devices (one stream each)
    rounds: int = 32                # emission steps the trace spans
    seed: int = 0                   # RNG seed — the whole trace identity
    base_rate: float = 0.25         # mean emission probability per round
    diurnal_period: int = 24        # rounds per simulated "day"
    diurnal_amp: float = 0.6        # envelope swing, fraction of base_rate
    burst_prob: float = 0.02        # chance a quiet device starts bursting
    burst_len: int = 3              # rounds a burst lasts
    burst_boost: float = 4.0        # rate multiplier while bursting
    walk_sigma: float = 0.5         # per-step stddev of the value walk
    value_lo: float = -40.0         # clamp range for readings
    value_hi: float = 80.0

    def __post_init__(self):
        if self.n_devices < 1 or self.rounds < 1:
            raise ValueError("need n_devices >= 1 and rounds >= 1")
        if not (0.0 < self.base_rate <= 1.0):
            raise ValueError(f"base_rate must be in (0, 1], got "
                             f"{self.base_rate}")


class SensorTrace:
    """Replayable emission schedule: ``steps()`` yields, per round, the
    device indices that fire and their readings.

    Device ``d``'s rate at round ``k`` is::

        base_rate * (1 + diurnal_amp * sin(2*pi*(k + phase_d)/period))
        * (burst_boost if d is mid-burst else 1)

    with a per-device phase offset so the fleet's diurnal peaks are
    staggered (every tenant has its own "timezone").  Readings follow a
    clamped Gaussian random walk per device, initialised uniformly in
    ``[value_lo, value_hi]``.
    """

    def __init__(self, cfg: TraceConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._phase = rng.uniform(0.0, cfg.diurnal_period, cfg.n_devices)
        self._values = rng.uniform(cfg.value_lo, cfg.value_hi, cfg.n_devices)
        self._burst_left = np.zeros(cfg.n_devices, np.int64)
        self._rng = rng
        self._k = 0

    def rate(self, k: int) -> np.ndarray:
        """Per-device emission probability at round ``k`` (before the
        burst multiplier), clipped to [0, 1]."""
        cfg = self.cfg
        envelope = 1.0 + cfg.diurnal_amp * np.sin(
            2.0 * np.pi * (k + self._phase) / cfg.diurnal_period)
        return np.clip(cfg.base_rate * envelope, 0.0, 1.0)

    def step(self) -> Tuple[np.ndarray, np.ndarray]:
        """Advance one round; returns ``(device_idx, values)`` — the
        (possibly empty) int64 indices of devices that emit this round
        and their float32 readings."""
        cfg = self.cfg
        # burst bookkeeping: quiet devices may start one, active decay
        start = self._rng.random(cfg.n_devices) < cfg.burst_prob
        self._burst_left = np.where((self._burst_left == 0) & start,
                                    cfg.burst_len,
                                    np.maximum(self._burst_left - 1, 0))
        rate = self.rate(self._k)
        rate = np.clip(np.where(self._burst_left > 0,
                                rate * cfg.burst_boost, rate), 0.0, 1.0)
        fired = np.nonzero(self._rng.random(cfg.n_devices) < rate)[0]
        # walk every device's value (even silent ones — sensors keep
        # integrating between reports)
        self._values = np.clip(
            self._values + self._rng.normal(0.0, cfg.walk_sigma,
                                            cfg.n_devices),
            cfg.value_lo, cfg.value_hi)
        self._k += 1
        return fired, self._values[fired].astype(np.float32)

    def steps(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Iterate the whole trace: yields ``(round, device_idx, values)``
        for each of ``cfg.rounds`` rounds."""
        for k in range(self.cfg.rounds):
            dev, vals = self.step()
            yield k, dev, vals
