"""Plain torch selection pop: the oracle and the CPU path of the
scheduler hot path (engine ``_pop`` with ``EngineConfig.scheduler ==
"packed"``) — the port of the JAX package's ``sched_pop/ref.py``.

Popping the global minimum of ``(priority, virtual fair tag, seq, slot)``
``batch`` times, bumping only the winning tenant's virtual tag, visits
exactly the slots the full-sort (lexsort) pop takes, in the same order:
within one tenant the composite key is monotone along the tenant's own
``(priority, seq)`` order, so the sorted queue is a merge of per-tenant
monotone runs.
"""
from __future__ import annotations

import torch

INT_MAX = torch.iinfo(torch.int32).max
# Virtual-time granularity shared with repro_torch.core.engine.FAIR_SCALE.
FAIR_SCALE = 1 << 15
# Within-tenant ranks saturate here so rank * FAIR_SCALE stays inside
# int32 at any queue depth (the clamp the lexsort path applies too).
RANK_LIM = INT_MAX // FAIR_SCALE - 1


def sched_pop_ref(prio, seq, valid, tenant, w_slot, batch: int
                  ) -> torch.Tensor:
    """Select the ``batch`` winning queue slots, lowest sort key first.

    prio/seq/tenant/w_slot: (Q,) int32 per-slot planes (priority by slot,
    FIFO seq, clipped owning tenant, the tenant's fair-share weight);
    valid: (Q,) bool.  Returns ``take``: (batch,) int32 slot indices —
    the slots (and order) the lexsort pop's ``order[:batch]`` yields,
    invalid filler slots included.

    Each step pops the minimum of ``(key, tag, seq, slot)`` with ``key =
    priority`` for valid slots and ``INT_MAX`` otherwise; a pop of a valid
    slot of a weighted tenant moves every live slot of that tenant to the
    tag ``min(popped, RANK_LIM) * FAIR_SCALE // w``.  Taken slots retire
    with key and tag at ``INT_MAX``, a pair no live slot reaches.  The
    loop runs on the tensors' device without reading anything back."""
    Q = prio.shape[0]
    dev = prio.device
    i32 = torch.int32
    iota = torch.arange(Q, dtype=i32, device=dev)
    prio, seq = prio.to(i32), seq.to(i32)
    tenant, w_slot = tenant.to(i32), w_slot.to(i32)
    key = torch.where(valid, prio, INT_MAX)
    tag = torch.zeros((Q,), dtype=i32, device=dev)
    pop_ten = torch.full((batch,), -2, dtype=i32, device=dev)
    take = torch.zeros((batch,), dtype=i32, device=dev)
    big = torch.full((), INT_MAX, dtype=i32, device=dev)
    for b in range(batch):
        c1 = key == key.min()
        m2 = torch.where(c1, tag, big).min()
        c2 = c1 & (tag == m2)
        m3 = torch.where(c2, seq, big).min()
        c3 = c2 & (seq == m3)
        # a (1,) index: a 0-dim one would be read back to the host
        i = torch.where(c3, iota, Q).min().long().reshape(1)
        was_valid = valid[i][0]
        t_i, w_i = tenant[i][0], w_slot[i][0]
        # valid pops of t_i so far, this one included (prior pops ride in
        # the (batch,) history; invalid pops record -2, no tenant's id)
        cnt = (pop_ten == t_i).sum(dtype=i32) + was_valid.to(i32)
        rank = torch.clamp(cnt, max=RANK_LIM)
        tagval = torch.where(w_i > 0,
                             rank * FAIR_SCALE // torch.clamp(w_i, min=1), 0)
        bump = was_valid & (tenant == t_i) & valid & (w_i > 0) & (tag != INT_MAX)
        tag = torch.where(bump, tagval.to(i32), tag)
        tag.index_fill_(0, i, INT_MAX)
        key.index_fill_(0, i, INT_MAX)
        pop_ten[b] = torch.where(was_valid, t_i, -2)
        take[b] = i[0].to(i32)
    return take
