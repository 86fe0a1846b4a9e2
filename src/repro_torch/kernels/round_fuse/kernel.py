"""Launchers of the CUDA round-fusion kernels, the Hopper ports of the JAX
package's Pallas ``fused_round_call``, ``apply_programs_call`` and
``exchange_compact_call``.

The Pallas megakernel held the whole (W, R) register file in VMEM, which
one SM's shared memory cannot hold at the default widths, so the fused
round is two launches on PyTorch's current stream: ``pop_dispatch`` (one
CTA: the sorted-selection pop of ``sched_pop/csrc/pop_select.cuh``, then
the fan-out) and ``apply_programs`` (CTAs of :data:`APPLY_ITEMS` work
items, each item's program, constants, co-input ids and register file
staged in shared memory before its VM runs), both in
``csrc/fused_round.cu``.  ``apply_programs_call`` launches the second
alone for the sharded round's post-exchange apply (every shard in one
launch), and ``exchange_compact_call`` the compaction of
``csrc/exchange_compact.cu`` (a grid over sender, destination and slot
tile; every bucket slot written once).  See the notes at the top of the
sources for what bounds them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.round_fuse.ref import RegLayout
from repro_torch.kernels.sched_pop.kernel import check_fits

_P, _I = ctypes.c_void_p, ctypes.c_int
APPLY_ITEMS = 32        # work items per CTA of apply_programs: one warp
SMEM_LIMIT = 232448     # dynamic shared bytes one CTA may opt in to (H100)


def _lib():
    lib = _build.load("fused_round")
    if not getattr(lib, "_typed", False):
        lib.pop_dispatch_launch.argtypes = [_P] * 10 + [_I] * 5 + [_P] * 8
        lib.pop_dispatch_launch.restype = _I
        lib.apply_programs_launch.argtypes = \
            [ctypes.POINTER(_I)] + [_I] * 7 + [_P] * 21
        lib.apply_programs_launch.restype = _I
        lib.apply_programs_smem.argtypes = [ctypes.POINTER(_I), _I, _I]
        lib.apply_programs_smem.restype = ctypes.c_longlong
        lib.apply_programs_items.restype = _I
        lib._typed = True
    return lib


def _on(x, dev, dtype) -> torch.Tensor:
    return x.to(device=dev, dtype=dtype).contiguous()


def _quad_pitch(n: int) -> int:
    return ((n + 3) & ~3) | 4


def apply_smem_bytes(layout: RegLayout, prog_len: int, n_consts: int) -> int:
    """Shared bytes of one ``apply_programs`` CTA — ``apply_smem_bytes`` of
    ``csrc/fused_round.cu``: per work item its program (16 B a step, at an
    odd pitch), its register file (``n_regs`` floats), and its constants
    and in_table entries (4 B each, at a pitch of a multiple of four that
    is no multiple of eight)."""
    return APPLY_ITEMS * (16 * (prog_len | 1) + 4 * (
        layout.n_regs + _quad_pitch(n_consts) + _quad_pitch(layout.max_in)))


def check_layout(layout: RegLayout, prog_len: int, n_consts: int) -> None:
    """Raise ``ValueError`` unless ``apply_programs`` takes this register
    layout with programs of ``prog_len`` steps and ``n_consts``
    constants: its segments contiguous, and one CTA's staged planes
    (:func:`apply_smem_bytes`) within :data:`SMEM_LIMIT`."""
    # the kernel zeroes [reg_result, n_regs) and fills the segments below
    # it in order: the engine's layout is contiguous
    if (layout.reg_inputs, layout.reg_prev, layout.reg_ts,
            layout.reg_trigger, layout.reg_result) != (
            0, layout.max_in * layout.channels,
            layout.max_in * layout.channels + layout.channels,
            layout.max_in * layout.channels + layout.channels + 1,
            layout.max_in * layout.channels + layout.channels + 2):
        raise ValueError(f"register layout {layout} is not contiguous")
    need = apply_smem_bytes(layout, prog_len, n_consts)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{layout.n_regs} registers, {prog_len} program steps, "
            f"{n_consts} constants and {layout.max_in} co-inputs per work "
            f"item need {need} shared bytes per CTA of {APPLY_ITEMS} items; "
            f"one CTA holds at most {SMEM_LIMIT}")


def _plan_apply(lib, layout: RegLayout, dev, rep: int, rows, t_sid,
                item_valid, wi_src, wi_ts, wi_vals, in_table, progs, consts,
                is_composite, active, values, timestamps):
    """Stage one ``apply_programs`` launch.  Tables are (n_tab, ...) with
    (W,) work items, or (S, n_tab, ...) with (S, W) work items (S shards,
    one grid row each); per-event planes hold W / rep entries per shard;
    the value/timestamp snapshot (n_snap, ...) is shared.
    ``item_valid=None`` takes ``rows >= 0``.  Returns ``(launch,
    (new_vals, ts_out, live, keep, keep_ts, passf, badf))``, each output
    shaped like ``rows``."""
    S = in_table.shape[0] if in_table.dim() == 3 else 1
    n_tab, M = in_table.shape[-2:]
    W = rows.shape[-1]
    L, K = progs.shape[-2], consts.shape[-1]
    n_snap = timestamps.shape[0]
    C = layout.channels
    if progs.data_ptr() % 16:
        raise ValueError("progs must be 16-byte aligned")
    if rows.numel() != S * W or W % rep:
        raise ValueError("work items do not match the tables' shards")
    shape = tuple(rows.shape)
    new_vals = torch.empty(shape + (C,), dtype=torch.float32, device=dev)
    ts_out = torch.empty(shape, dtype=torch.int32, device=dev)
    masks = [torch.empty(shape, dtype=torch.bool, device=dev)
             for _ in range(5)]
    ins = (rows, t_sid, item_valid, wi_src, wi_ts, wi_vals, in_table,
           progs, consts, is_composite, active, values, timestamps)
    fn = lib.apply_programs_launch
    args = ((_I * 10)(*layout), S, W, n_tab, n_snap, L, K, rep,
            _build.ptr(rows), _build.ptr(t_sid),
            None if item_valid is None else _build.ptr(item_valid),
            *[_build.ptr(t) for t in (wi_src, wi_ts, wi_vals, in_table,
                                      progs, consts, is_composite, active,
                                      values, timestamps, new_vals, ts_out,
                                      *masks)],
            _build.stream_ptr(dev))

    def launch(keep_alive=(ins, new_vals, ts_out, masks)):
        _build.check(fn(*args), "apply_programs")

    live, keep, keep_ts, passf, badf = masks
    return launch, (new_vals, ts_out, live, keep, keep_ts, passf, badf)


def plan_fused_round(prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts,
                     batch: int, out_table, in_table, progs, consts,
                     is_composite, active, values, timestamps,
                     layout: RegLayout):
    """Check and stage one fused round on the card without launching it:
    inputs converted, outputs allocated.  Returns ``((pop_launch,
    apply_launch), outputs)``; each launch function enqueues its CUDA
    kernel on PyTorch's current stream and does no other host work (so
    the kernels can be timed alone), ``apply_launch`` after
    ``pop_launch``.  ``outputs`` is what ``fused_round_call`` returns."""
    check_layout(layout, progs.shape[-2], consts.shape[-1])
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError("fused_round_call takes CUDA tensors")
    Q, C = vals.shape
    N, F = out_table.shape
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    if not 0 < batch <= Q:
        raise ValueError(f"batch {batch} outside [1, {Q}]")
    if C != layout.channels or in_table.shape != (N, layout.max_in):
        raise ValueError("tables do not match the register layout")
    check_fits(Q, batch)
    lib = _lib()

    q_in = [_on(prio_slot, dev, i32), _on(seq, dev, i32),
            _on(valid, dev, b8), _on(t_slot, dev, i32),
            _on(w_slot, dev, i32), _on(sid, dev, i32), _on(ts, dev, i32),
            _on(vals, dev, f32)]
    out_table = _on(out_table, dev, i32)
    active = _on(active, dev, b8)
    W = batch * F
    take = torch.empty((batch,), dtype=i32, device=dev)
    e_sid, e_ts = torch.empty_like(take), torch.empty_like(take)
    e_pop = torch.empty((batch,), dtype=b8, device=dev)
    e_act = torch.empty_like(e_pop)
    e_vals = torch.empty((batch, C), dtype=f32, device=dev)
    wi_t = torch.empty((W,), dtype=i32, device=dev)
    pop_outs = (take, e_sid, e_ts, e_pop, e_act, e_vals, wi_t)
    pop_fn = lib.pop_dispatch_launch
    pop_args = (*[_build.ptr(t) for t in (*q_in, out_table, active)],
                Q, C, batch, N, F, *[_build.ptr(t) for t in pop_outs],
                _build.stream_ptr(dev))

    def pop_launch(keep_alive=(q_in, out_table, active, pop_outs)):
        _build.check(pop_fn(*pop_args), "pop_dispatch")

    apply_launch, applied = _plan_apply(
        lib, layout, dev, F, wi_t, wi_t, None, e_sid, e_ts, e_vals,
        _on(in_table, dev, i32), _on(progs, dev, i32),
        _on(consts, dev, f32), _on(is_composite, dev, b8), active,
        _on(values, dev, f32), _on(timestamps, dev, i32))
    return (pop_launch, apply_launch), \
        (take, (e_sid, e_vals, e_ts, e_pop, e_act), wi_t, applied)


def fused_round_call(prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts,
                     batch: int, out_table, in_table, progs, consts,
                     is_composite, active, values, timestamps,
                     layout: RegLayout):
    """Run the fused round on the card: ``pop_dispatch`` then
    ``apply_programs`` on PyTorch's current stream.  Per-slot planes as
    in ``sched_pop_call``; per-row tables are the engine's (N, ...)
    DeviceTables leaves.  Returns ``(take, (e_sid, e_vals, e_ts, e_pop,
    e_act), wi_t, (new_vals, ts_out, live, keep, keep_ts, passf, badf))``
    — bit-identical to the ``ref.py`` composition.  Counts one launch per
    call (both CUDA kernels) in ``fused_round_call.launches``."""
    launches, out = plan_fused_round(
        prio_slot, seq, valid, t_slot, w_slot, sid, vals, ts, batch,
        out_table, in_table, progs, consts, is_composite, active, values,
        timestamps, layout)
    for launch in launches:
        launch()
    fused_round_call.launches += 1
    return out


fused_round_call.launches = 0


def plan_apply_programs(layout: RegLayout, in_table, progs, consts,
                        is_composite, active, rows, t_sid, wi_src, wi_vals,
                        wi_ts, wi_valid, values_by_sid, timestamps_by_sid):
    """Check and stage stages 2+3 alone on the card without launching
    them.  Per-row tables are (S, n_tab, ...) with (S, W) work items:
    every shard in one launch, each reading its own table slice.  ``rows`` index the tables,
    ``t_sid`` and every co-input the shared (n_snap, ...) snapshot.
    Returns ``(launch, outputs)``: ``launch`` only enqueues the kernel,
    ``outputs`` is what ``apply_programs_call`` returns.  A layout that
    :func:`check_layout` refuses raises ``ValueError`` first, on any
    device."""
    check_layout(layout, progs.shape[-2], consts.shape[-1])
    dev = wi_vals.device
    if dev.type != "cuda":
        raise ValueError("apply_programs_call takes CUDA tensors")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    if in_table.dim() != 3:
        raise ValueError("apply_programs_call takes (S, n_tab, ...) tables")
    S, n_tab = in_table.shape[:2]
    W = rows.shape[-1]
    C = layout.channels
    if in_table.shape[-1] != layout.max_in or wi_vals.shape[-1] != C:
        raise ValueError("tables do not match the register layout")
    if tuple(rows.shape) != (S, W) or tuple(progs.shape[:-2]) != \
            (S, n_tab) or values_by_sid.shape[-1] != C:
        raise ValueError("apply_programs_call: inconsistent shapes")
    return _plan_apply(
        _lib(), layout, dev, 1, _on(rows, dev, i32), _on(t_sid, dev, i32),
        _on(wi_valid, dev, b8), _on(wi_src, dev, i32), _on(wi_ts, dev, i32),
        _on(wi_vals, dev, f32), _on(in_table, dev, i32),
        _on(progs, dev, i32), _on(consts, dev, f32),
        _on(is_composite, dev, b8), _on(active, dev, b8),
        _on(values_by_sid, dev, f32), _on(timestamps_by_sid, dev, i32))


def apply_programs_call(layout: RegLayout, in_table, progs, consts,
                        is_composite, active, rows, t_sid, wi_src, wi_vals,
                        wi_ts, wi_valid, values_by_sid, timestamps_by_sid):
    """Stages 2+3 alone on the card (the sharded round's post-exchange
    apply; shapes as in ``plan_apply_programs``).  Returns ``(new_vals,
    ts_out, live, keep, keep_ts, passf, badf)`` — bit-identical to
    ``ref.apply_programs_ref`` shard by shard.  Counts one launch per
    call in ``apply_programs_call.launches``."""
    launch, out = plan_apply_programs(
        layout, in_table, progs, consts, is_composite, active, rows, t_sid,
        wi_src, wi_vals, wi_ts, wi_valid, values_by_sid, timestamps_by_sid)
    launch()
    apply_programs_call.launches += 1
    return out


apply_programs_call.launches = 0

MAX_SHARDS = 32         # destinations exchange_compact takes


def _exchange_lib():
    lib = _build.load("exchange_compact")
    if not getattr(lib, "_typed", False):
        lib.exchange_compact_launch.argtypes = [_I] * 5 + [_P] * 10
        lib.exchange_compact_launch.restype = _I
        lib._typed = True
    return lib


def plan_exchange_compact(wi_t, wi_src, wi_ts, wi_its, wi_vals, dest_shard,
                          n_shards: int, slots: int):
    """Check and stage the exchange compaction on the card without
    launching it.  Work items are (S, W) planes of S senders (one launch
    for all);
    ``dest_shard == n_shards`` marks unrouted lanes.  Returns ``(launch,
    (xi, xf, x_drop))`` shaped as ``exchange_compact_call`` returns
    them."""
    dev = wi_vals.device
    if dev.type != "cuda":
        raise ValueError("exchange_compact_call takes CUDA tensors")
    if not 1 <= n_shards <= MAX_SHARDS or slots < 1:
        raise ValueError(f"{n_shards} shards x {slots} slots: the kernel "
                         f"takes 1..{MAX_SHARDS} shards and >= 1 slot")
    if wi_t.dim() != 2:
        raise ValueError("exchange_compact_call takes (S, W) work items")
    S, W = wi_t.shape
    C = wi_vals.shape[-1]
    if wi_vals.shape[:-1] != wi_t.shape:
        raise ValueError("exchange_compact_call: inconsistent shapes")
    i32 = torch.int32
    ins = [_on(x, dev, i32) for x in (wi_t, wi_src, wi_ts, wi_its)]
    vals = _on(wi_vals, dev, torch.float32)
    dest = _on(dest_shard, dev, i32)
    xi = torch.empty((S, n_shards, slots, 4), dtype=i32, device=dev)
    xf = torch.empty((S, n_shards, slots, C), dtype=torch.float32,
                     device=dev)
    drop = torch.empty(tuple(wi_t.shape), dtype=torch.bool, device=dev)
    fn = _exchange_lib().exchange_compact_launch
    args = (S, W, C, n_shards, slots,
            *[_build.ptr(t) for t in (*ins, vals, dest, xi, xf, drop)],
            _build.stream_ptr(dev))

    def launch(keep_alive=(ins, vals, dest, xi, xf, drop)):
        _build.check(fn(*args), "exchange_compact")

    return launch, (xi, xf, drop)


def exchange_compact_call(wi_t, wi_src, wi_ts, wi_its, wi_vals, dest_shard,
                          n_shards: int, slots: int):
    """Rank-and-scatter work items into (n_shards, slots) exchange
    buckets on the card, array order kept per destination (shapes as in
    ``plan_exchange_compact``).  Returns ``(xi, xf, x_drop)``: int32
    ``(t, src, ts, its)`` buckets (-1 where empty), float32 payloads
    (+0.0 where empty, bits unchanged) and the per-item overflow mask —
    bit-identical to ``ref.exchange_compact_ref`` sender by sender.
    Counts one launch per call in ``exchange_compact_call.launches``."""
    launch, out = plan_exchange_compact(wi_t, wi_src, wi_ts, wi_its,
                                        wi_vals, dest_shard, n_shards, slots)
    launch()
    exchange_compact_call.launches += 1
    return out


exchange_compact_call.launches = 0
