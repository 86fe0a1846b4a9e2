"""Dispatch wrapper for the fused round.

``fused_stages`` is the single-device stages 1-3 (engine ``make_step``
with ``fused_round`` on): the CUDA kernel pair of ``kernel.py`` for
tensors on the card, the plain torch refs for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.round_fuse.ref import (
    RegLayout, apply_programs_ref, pop_dispatch_ref)


def fused_stages(prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts,
                 batch: int, out_table, in_table, progs, consts,
                 is_composite, active, values, timestamps,
                 layout: RegLayout, *, use_kernel: Optional[bool] = None):
    """Stages 1-3 of the single-device round as one operation: packed
    top-``batch`` pop, fan-out, co-input fetch + reduced-branch VM, and
    the Listing-2 window gate.  Per-slot planes as in ``sched_pop``; the
    tables/state leaves are the engine's (N, ...) tensors.  Returns
    ``(take, (e_sid, e_vals, e_ts, e_pop, e_act), wi_t, (new_vals,
    ts_out, live, keep, keep_ts, passf, badf))`` — wi_t already -1 for
    invalid/revoked lanes, so ``wi_t >= 0`` is the work-item validity
    mask."""
    if wants_kernel(use_kernel, vals):
        from repro_torch.kernels.round_fuse.kernel import fused_round_call
        return fused_round_call(prio_slot, seq, valid, t_slot, w_slot, sid,
                                vals, ts, batch, out_table, in_table, progs,
                                consts, is_composite, active, values,
                                timestamps, layout)
    take, popped, (wi_t, wi_src, wi_vals, wi_ts) = pop_dispatch_ref(
        prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts, batch,
        out_table, active)
    N = out_table.shape[0]
    rows = torch.clamp(wi_t, 0, N - 1)
    applied = apply_programs_ref(
        layout, in_table, progs, consts, is_composite, active,
        rows, rows, wi_src, wi_vals, wi_ts, wi_t >= 0, values, timestamps)
    return take, popped, wi_t, applied
