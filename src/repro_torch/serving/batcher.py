"""Continuous batching decode server (the port of
``repro.serving.batcher``).

A fixed pool of B cache slots; requests are admitted into free slots as
they arrive (no batch barrier), every tick decodes one token for all
live slots, finished requests (EOS / max_tokens) free their slot
immediately.  Per-slot positions go to the model plane's decode step as
its per-row ``pos``, so slots at different depths share one step.

The host protocol is ``repro``'s: prompts are fed one token a tick
through the decode step, the tick's logits are read back to the host as
float32 once, and the next token is ``np.argmax`` of that copy (the first
maximum; a NaN wins).  A slot's caches are not reset when a new request
takes it (its position restarts at 0: attention masks the old entries,
while recurrent states carry over), and a dead slot decodes token 0 —
both as in ``repro``.  On the card a tick's tokens and positions reach
the device in one copy from pinned memory and its logits come back in
one readback, the tick's only host synchronisation.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids, at most
    ``max_tokens`` new tokens (fewer at ``eos``); the server fills
    ``output`` and ``done``.  ``tenant`` is what the throttle hook reads."""
    rid: int
    prompt: List[int]
    max_tokens: int = 16
    eos: Optional[int] = None
    tenant: int = 0
    # filled by the server:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Decode server over ``cfg`` with ``params`` (a parameter tree of
    tensors; cast once here with ``cast_params`` and moved to ``device``).
    ``device`` defaults to the card and raises without CUDA;
    ``use_kernel`` goes to the decode step (``False``: the kernels'
    plain versions on the card)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, greedy: bool = True, device="cuda",
                 use_kernel: Optional[bool] = None):
        assert cfg.n_codebooks == 1 and not cfg.embed_inputs, \
            "batcher serves token-in/token-out archs"
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = M.tree_map(lambda t: t.to(self.device),
                                  M.cast_params(cfg, params))
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.use_kernel = use_kernel
        self._decode = M.make_decode_step(cfg, use_kernel=use_kernel)
        self.caches = M.init_cache(cfg, slots, max_len, self.device)
        self.pos = np.zeros((slots,), np.int32)
        self.tokens = np.zeros((slots, 1), np.int32)
        # the tick's (tokens, pos) as one host buffer: pinned on the card,
        # so its copy is asynchronous
        self._staging = torch.zeros(
            (2, slots), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        self.live: List[Optional[Request]] = [None] * slots
        self.budget: Dict[int, int] = {}         # remaining tokens per request
        self.queue: Deque[Request] = deque()
        self._pending_prompt: Dict[int, Deque[int]] = {}
        self.ticks = 0
        # backpressure hook (QoS plane): when set, queued requests for
        # which throttle(req) is True wait — they keep their queue order
        # but are passed over for decode slots until the hook clears
        # (the serving bridge points this at the engine's per-tenant
        # queue-occupancy watermark)
        self.throttle: Optional[Callable[[Request], bool]] = None

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> None:
        """Queue ``req``; it takes a slot at a later tick's admission."""
        self.queue.append(req)

    def _next_admittable(self) -> Optional[Request]:
        """Pop the oldest queued request the throttle hook allows (all of
        them, when no hook is set); None when every queued request waits."""
        if self.throttle is None:
            return self.queue.popleft() if self.queue else None
        for i, req in enumerate(self.queue):
            if not self.throttle(req):
                del self.queue[i]
                return req
        return None

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.live[s] is None and self.queue:
                req = self._next_admittable()
                if req is None:
                    break
                # prefill the slot by feeding prompt tokens one at a time
                # through the shared decode step (slot-local positions make
                # this safe next to running slots); the slot's caches are
                # kept, as in repro
                self.live[s] = req
                self.pos[s] = 0
                self._pending_prompt[s] = deque(req.prompt)
                self.budget[req.rid] = req.max_tokens

    # ---------------------------------------------------------------- tick
    def _step(self) -> np.ndarray:
        """One decode step of every slot: (slots, V) float32 host logits."""
        self._staging[0] = torch.from_numpy(self.tokens[:, 0])
        self._staging[1] = torch.from_numpy(self.pos)
        dev = self._staging.to(self.device, non_blocking=True)
        logits, self.caches = self._decode(
            self.params, self.caches, {"tokens": dev[0][:, None]}, dev[1])
        return logits[:, 0].float().cpu().numpy()

    def tick(self) -> List[Request]:
        """One decode step for all live slots.  Returns finished requests."""
        self._admit()
        pending = self._pending_prompt
        for s, req in enumerate(self.live):
            if req is None:
                self.tokens[s, 0] = 0
                continue
            if pending.get(s):
                self.tokens[s, 0] = pending[s].popleft()
            elif req.output:
                self.tokens[s, 0] = req.output[-1]
        logits = self._step()
        finished = []
        for s, req in enumerate(self.live):
            if req is None:
                continue
            self.pos[s] += 1
            if pending.get(s):                 # still prefilling this slot
                continue
            nxt = int(np.argmax(logits[s]))
            req.output.append(nxt)
            self.budget[req.rid] -= 1
            if ((req.eos is not None and nxt == req.eos)
                    or self.budget[req.rid] <= 0
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.live[s] = None            # slot freed immediately
        self.ticks += 1
        return finished

    def run_ticks(self, n: int) -> List[Request]:
        """A serving superstep: up to ``n`` decode ticks back to back,
        stopping early when no request is queued or live.  The serving
        bridge calls this once per engine superstep instead of ticking
        token by token around its own bookkeeping."""
        done: List[Request] = []
        for _ in range(n):
            if all(r is None for r in self.live) and (
                    not self.queue or (self.throttle is not None and
                                       all(map(self.throttle, self.queue)))):
                break           # nothing live, nothing admittable
            done += self.tick()
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Run ticks until nothing is left to decode (bounded by
        ``max_ticks``); returns the finished requests.  With a
        ``throttle`` hook set, backpressured requests may remain queued —
        they decode after the hook clears (the bridge's release path)."""
        return self.run_ticks(max_ticks)
