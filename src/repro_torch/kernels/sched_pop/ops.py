"""Dispatch wrapper for the selection-based scheduler pop.

``sched_pop()`` is the entry point the engine's ``_pop`` calls on the
``"packed"`` scheduler: the CUDA kernel (``kernel.sched_pop_call``) for
tensors on the card, the plain torch loop (``ref.sched_pop_ref``) for
tensors on the CPU.  Both are bit-identical to each other and to the
lexsort pop.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.sched_pop.ref import sched_pop_ref


def sched_pop(prio, seq, valid, tenant, w_slot, sid, vals, ts, batch: int,
              *, use_kernel: Optional[bool] = None) -> Tuple:
    """Pop the ``batch`` winning queue slots and gather their payloads.

    prio/seq/tenant/w_slot/sid/ts: (Q,) int32 per-slot planes; valid:
    (Q,) bool; vals: (Q, C) float32.  Returns ``(take, (p_sid, p_vals,
    p_ts, p_valid))``: the winning slot indices (batch,) int32 in pop
    order and their gathered rows.  ``use_kernel=None`` follows the
    tensors' device; ``False`` runs the plain version on any device."""
    if wants_kernel(use_kernel, vals):
        from repro_torch.kernels.sched_pop.kernel import sched_pop_call
        return sched_pop_call(prio, seq, valid, tenant, w_slot, sid, vals,
                              ts, batch)
    take = sched_pop_ref(prio, seq, valid, tenant, w_slot, batch)
    t = take.long()
    return take, (sid[t], vals[t], ts[t], valid[t])
