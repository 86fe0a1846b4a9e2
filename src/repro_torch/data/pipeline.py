"""Deterministic synthetic data pipelines (the port's copy of
``repro.data.pipeline``: numpy only, so a batch is equal bit for bit in
both packages).

Design constraints for a production loop:
  * **restart-reproducible** — a batch is a pure function of (seed, step),
    so checkpoint/restart resumes the exact token stream with no reader
    state to persist;
  * **host-sharded** — each host materializes only its slice
    (`host_index / host_count`);
  * **cheap** — counter-based hashing: a splitmix-style mix on numpy
    uint64.

The LM corpus has learnable structure (a periodic Markov-ish mixture), so
training loss decreases.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class SyntheticCorpus:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    n_codebooks: int = 1
    structure: float = 0.85     # fraction of tokens following the pattern

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        B, L, V = self.local_batch, self.seq_len, self.vocab
        K = self.n_codebooks
        row0 = self.host_index * B
        rows = (np.uint64(step) << np.uint64(32)) + np.uint64(row0) + \
            np.arange(B, dtype=np.uint64)
        rows = _mix(rows + np.uint64(self.seed) * np.uint64(0x1000003))
        pos = np.arange(L + 1, dtype=np.uint64)
        # structured stream: x_{t+1} = (a*x_t + b) mod V with per-row (a, b),
        # corrupted by hash noise with prob (1 - structure)
        a = (rows % np.uint64(V - 3) + np.uint64(2)).astype(np.uint64)
        b = (rows >> np.uint64(7)) % np.uint64(V)
        shape = (B, L + 1, K) if K > 1 else (B, L + 1)
        x0 = rows % np.uint64(V)
        t = pos[None, :] if K == 1 else pos[None, :, None]
        ar = a[:, None] if K == 1 else a[:, None, None]
        br = b[:, None] if K == 1 else b[:, None, None]
        x0r = x0[:, None] if K == 1 else x0[:, None, None]
        kk = np.uint64(0) if K == 1 else np.arange(K, dtype=np.uint64)[None, None, :]
        base = (x0r + ar * t + br * (t * t) + kk * np.uint64(97)) % np.uint64(V)
        noise_bits = _mix(rows.reshape(-1, *([1] * (len(shape) - 1))) ^
                          _mix(t * np.uint64(0x9E37) + kk * np.uint64(13)))
        is_noise = (noise_bits % np.uint64(1000)) >= np.uint64(
            int(self.structure * 1000))
        noise_tok = noise_bits % np.uint64(V)
        toks = np.where(is_noise, noise_tok, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class SensorUpdateGenerator:
    """Deterministic Sensor Update stream for engine benchmarks: each
    source stream emits a sinusoid + hash jitter at its own phase."""
    n_sources: int
    channels: int = 1
    seed: int = 0

    def updates(self, t: int) -> np.ndarray:
        """(n_sources, channels) float32 values for timestamp t."""
        src = np.arange(self.n_sources, dtype=np.uint64)
        ch = np.arange(self.channels, dtype=np.uint64)
        h = _mix((src[:, None] << np.uint64(16)) ^ ch[None, :] ^
                 np.uint64(self.seed + t))
        jitter = (h % np.uint64(1000)).astype(np.float32) / 1000.0
        phase = (src % np.uint64(17)).astype(np.float32)[:, None]
        return np.sin(0.1 * t + phase).astype(np.float32) + 0.1 * jitter
