"""Deterministic chaos-injection harness for the fault-isolation plane —
the PyTorch port of the JAX package's ``repro.launch.chaos`` (host Python
only: the injectors call the engine's host API, and the damage they do is
what the engine's rounds on the card must absorb).

Every injector is driven by a ``numpy.random.Generator`` seeded by the
caller, so any failure the harness finds is *replayable from its seed*:
the repro recipe is the ``(seed, schedule)`` pair.  The draws are the JAX
package's, in the same order, so one seed gives the same schedule, the
same poisoned lanes and the same torn bytes in both packages.  Injectors
cover the failure classes of tenants deploying their own Service Object
code on a shared runtime:

* **payload corruption** — SUs carrying NaN/Inf/absurd magnitudes, the
  upstream-sensor-gone-bad case (:func:`poison_payload`,
  :func:`inject_payload_corruption`);
* **hostile bytecode** — a tenant swaps a live program for one whose
  arithmetic overflows to Inf (fusable opcodes only, so the *fused* round
  must catch it too) (:func:`hostile_transform`,
  :func:`inject_hostile_program`);
* **ingest storms** — one tenant floods the queue far beyond its fair
  share (:func:`inject_ingest_storm`);
* **shard kill** — the driving process loses its engine mid-run
  (:class:`ShardKill`, raised between supersteps by a chaos callback;
  :class:`~repro_torch.launch.supervise.Supervisor` recovers from the
  newest valid checkpoint);
* **torn checkpoints** — the newest checkpoint is truncated or bit-flipped
  on disk (:func:`corrupt_checkpoint`), which is what the checksum and
  newest-valid fallback of :mod:`repro_torch.checkpoint.ckpt` exist for.

:class:`ChaosMonkey` composes them into a seeded per-superstep schedule.

The VM's opcodes are individually hardened (``DIV`` by zero yields 0,
``LOG``/``SQRT`` clamp), so hostile *bytecode* cannot produce NaN out of
nothing: the overflow route (float32 ``MUL`` chains into Inf) and the
corrupted-payload route (non-finite inputs propagate through arithmetic)
are the two ways real poison arrives, and both are what the breaker's
non-finite detector sees.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class ShardKill(Exception):
    """A chaos-injected process/shard death: the engine object (and every
    device buffer it held) must be treated as lost.  Raised between
    supersteps; the supervisor's recovery path (restore the newest valid
    checkpoint, replay the feed) is the handler."""


# --------------------------------------------------------------------------
# payload corruption
# --------------------------------------------------------------------------

POISON_KINDS = ("nan", "inf", "-inf", "huge")


def poison_payload(rng: np.random.Generator, channels: int,
                   kind: Optional[str] = None) -> np.ndarray:
    """One corrupted SU payload: a ``(channels,)`` float32 vector with at
    least one poisoned lane (NaN, ±Inf, or a magnitude near the float32
    edge that overflows downstream arithmetic)."""
    if kind is None:
        kind = POISON_KINDS[int(rng.integers(len(POISON_KINDS)))]
    vals = rng.standard_normal(channels).astype(np.float32)
    lane = int(rng.integers(channels))
    if kind == "nan":
        vals[lane] = np.nan
    elif kind == "inf":
        vals[lane] = np.inf
    elif kind == "-inf":
        vals[lane] = -np.inf
    elif kind == "huge":
        vals[lane] = np.float32(3.0e38)     # one MUL from Inf
    else:
        raise ValueError(f"unknown poison kind {kind!r}")
    return vals


def inject_payload_corruption(eng, stream, ts: int,
                              rng: np.random.Generator,
                              kind: Optional[str] = None) -> np.ndarray:
    """Post one corrupted SU to ``stream``; returns the payload posted."""
    vals = poison_payload(rng, eng.cfg.channels, kind)
    eng.post(stream, vals, ts=ts)
    return vals


# --------------------------------------------------------------------------
# hostile bytecode
# --------------------------------------------------------------------------

def hostile_transform(input_name: str, channels: Sequence[str],
                      mode: str = "overflow") -> Dict[str, str]:
    """A transform dict whose compiled program is hostile but *fusable*
    (MUL/ADD only — no transcendental opcodes), so both the fused and the
    staged rounds execute it and must agree on detection:

    * ``"overflow"`` — multiplies the input into float32 Inf
      (``3e38 * 3e38``): the non-finite detector's bytecode-borne case;
    * ``"amplify"`` — an innocent-looking identity: amplification hostility
      lives in the *fan-out*, so pair this with many subscriptions and an
      ``amp_ceiling`` (the program itself stays clean).
    """
    if mode == "overflow":
        expr = f"{input_name}.{{c}} * 3.0e38 * 3.0e38"
    elif mode == "amplify":
        expr = f"{input_name}.{{c}}"
    else:
        raise ValueError(f"unknown hostile mode {mode!r}")
    return {c: expr.format(c=c) for c in channels}


def inject_hostile_program(eng, stream, inputs: Sequence,
                           rng: np.random.Generator,
                           mode: str = "overflow") -> None:
    """Swap ``stream``'s live program for a hostile one (a tenant pushing
    bad code through the program-swap plane, ``StreamEngine.swap_program``:
    an in-place table edit).  ``inputs`` are the stream's input streams
    (their names feed the expression compiler); one is chosen by the rng
    so replays pick the same victim edge."""
    src = inputs[int(rng.integers(len(inputs)))]
    names = list(getattr(stream, "channels", ["v"]))
    eng.swap_program(stream, hostile_transform(src.name, names, mode))


# --------------------------------------------------------------------------
# ingest storm
# --------------------------------------------------------------------------

def inject_ingest_storm(eng, streams: Sequence, ts0: int,
                        rng: np.random.Generator, n: int = 256) -> int:
    """Flood ``n`` SUs across ``streams`` in one burst (timestamps
    monotone from ``ts0``) — the noisy-neighbor load case the QoS plane
    (quota/weighted-fair pop) must absorb.  Returns the next free ts."""
    C = eng.cfg.channels
    for i in range(n):
        s = streams[int(rng.integers(len(streams)))]
        eng.post(s, rng.standard_normal(C).astype(np.float32), ts=ts0 + i)
    return ts0 + n


# --------------------------------------------------------------------------
# torn checkpoints
# --------------------------------------------------------------------------

def corrupt_checkpoint(path: str, rng: np.random.Generator,
                       mode: Optional[str] = None,
                       step: Optional[int] = None) -> Optional[str]:
    """Damage one on-disk checkpoint (default: the newest) the way real
    storage does: ``"truncate"`` a leaf file, ``"bitflip"`` one byte of a
    leaf, or ``"manifest"``-truncate the manifest itself.  Returns the
    damaged file's path (None when there is no checkpoint to damage).
    The target leaf/byte is rng-chosen, so a given seed always tears the
    same bytes (the on-disk format is the JAX package's, so also the same
    bytes as its injector)."""
    from repro_torch.checkpoint import ckpt
    if step is None:
        step = ckpt.latest_step(path)
    if step is None:
        return None
    if mode is None:
        mode = ("truncate", "bitflip", "manifest")[int(rng.integers(3))]
    d = os.path.join(path, f"step_{step:08d}")
    if mode == "manifest":
        victim = os.path.join(d, "manifest.json")
    else:
        leaves = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
        if not leaves:
            return None
        victim = os.path.join(d, leaves[int(rng.integers(len(leaves)))])
    size = os.path.getsize(victim)
    if mode == "truncate" or mode == "manifest":
        with open(victim, "r+b") as f:
            f.truncate(int(rng.integers(max(size // 2, 1))))
    elif mode == "bitflip":
        ofs = int(rng.integers(max(size, 1)))
        with open(victim, "r+b") as f:
            f.seek(ofs)
            b = f.read(1)
            f.seek(ofs)
            f.write(bytes([(b[0] if b else 0) ^ (1 << int(rng.integers(8)))]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return victim


# --------------------------------------------------------------------------
# the composed schedule
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ChaosEvent:
    """One scheduled injection, for logs and replay manifests."""
    step: int
    kind: str           # "poison" | "hostile" | "storm" | "kill" | "tear"
    detail: str = ""


class ChaosMonkey:
    """Seeded per-superstep chaos schedule.

    Built once from ``(seed, n_steps, rates)``; :meth:`events_at` returns
    the injections scheduled for a given superstep index.  The schedule is
    a pure function of the seed — two monkeys with the same arguments
    produce identical schedules, which is what lets a drill assert
    bit-exactness against an undisturbed twin run that *skips* the
    kill/tear events but replays the same poison/storm feed."""

    def __init__(self, seed: int, n_steps: int, *,
                 p_poison: float = 0.15, p_storm: float = 0.05,
                 kill_steps: Sequence[int] = (), tear_steps: Sequence[int] = (),
                 hostile_steps: Sequence[int] = ()):
        self.seed = int(seed)
        self.n_steps = int(n_steps)
        rng = np.random.default_rng(self.seed)
        self.events: List[ChaosEvent] = []
        for step in range(self.n_steps):
            if rng.random() < p_poison:
                kind = POISON_KINDS[int(rng.integers(len(POISON_KINDS)))]
                self.events.append(ChaosEvent(step, "poison", kind))
            if rng.random() < p_storm:
                self.events.append(ChaosEvent(step, "storm"))
        self.events += [ChaosEvent(int(s), "kill") for s in kill_steps]
        self.events += [ChaosEvent(int(s), "tear") for s in tear_steps]
        self.events += [ChaosEvent(int(s), "hostile") for s in hostile_steps]
        self.events.sort(key=lambda e: (e.step, e.kind))
        # injectors draw from their own stream so adding/removing a class
        # never shifts another class's draws (replay stability)
        self.rng = np.random.default_rng(self.seed + 1)

    def events_at(self, step: int) -> List[ChaosEvent]:
        return [e for e in self.events if e.step == step]

    def manifest(self) -> List[dict]:
        """JSON-able schedule (for incident logs / benchmark records)."""
        return [dataclasses.asdict(e) for e in self.events]
