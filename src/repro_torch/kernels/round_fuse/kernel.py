"""Launchers of the CUDA fused round (``csrc/fused_round.cu``), the Hopper
port of the JAX package's Pallas ``fused_round_call``.

The Pallas megakernel held the whole (W, R) register file in VMEM, which
one SM's shared memory cannot hold at the default widths, so the round
is two launches on PyTorch's current stream: ``pop_dispatch`` (one CTA:
selection pop + fan-out) and ``apply_programs`` (a grid over the W work
items: co-input fetch, VM, window gate).  See the note at the top of the
source for what bounds them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.round_fuse.ref import RegLayout
from repro_torch.kernels.sched_pop.kernel import check_fits

_P, _I = ctypes.c_void_p, ctypes.c_int
APPLY_THREADS = 128     # work items per CTA of apply_programs


def _lib():
    lib = _build.load("fused_round")
    if not getattr(lib, "_typed", False):
        lib.pop_dispatch_launch.argtypes = [_P] * 10 + [_I] * 5 + [_P] * 8
        lib.pop_dispatch_launch.restype = _I
        lib.apply_programs_launch.argtypes = \
            [ctypes.POINTER(_I)] + [_I] * 5 + [_P] * 21
        lib.apply_programs_launch.restype = _I
        lib._typed = True
    return lib


def _on(x, dev, dtype) -> torch.Tensor:
    return x.to(device=dev, dtype=dtype).contiguous()


def _check_layout(layout: RegLayout) -> None:
    # the kernel zeroes [reg_result, n_regs) and fills the segments below
    # it in order: the engine's layout is contiguous
    if (layout.reg_inputs, layout.reg_prev, layout.reg_ts,
            layout.reg_trigger, layout.reg_result) != (
            0, layout.max_in * layout.channels,
            layout.max_in * layout.channels + layout.channels,
            layout.max_in * layout.channels + layout.channels + 1,
            layout.max_in * layout.channels + layout.channels + 2):
        raise ValueError(f"register layout {layout} is not contiguous")
    if 4 * layout.n_regs * APPLY_THREADS > 232448:
        raise ValueError(f"{layout.n_regs} registers per item do not fit "
                         "one CTA's shared memory")


def _plan_apply(lib, layout: RegLayout, dev, rep: int, rows, t_sid,
                item_valid, wi_src, wi_ts, wi_vals, in_table, progs, consts,
                is_composite, active, values, timestamps):
    """Stage one ``apply_programs`` launch; ``rows``/``t_sid`` (W,),
    per-event planes (W / rep,).  ``item_valid=None`` takes ``rows >= 0``.
    Returns ``(launch, (new_vals, ts_out, live, keep, keep_ts, passf,
    badf))``."""
    W = rows.shape[0]
    N, M = in_table.shape
    L, K = progs.shape[1], consts.shape[1]
    C = layout.channels
    if progs.data_ptr() % 16:
        raise ValueError("progs must be 16-byte aligned")
    new_vals = torch.empty((W, C), dtype=torch.float32, device=dev)
    ts_out = torch.empty((W,), dtype=torch.int32, device=dev)
    masks = [torch.empty((W,), dtype=torch.bool, device=dev)
             for _ in range(5)]
    ins = (rows, t_sid, item_valid, wi_src, wi_ts, wi_vals, in_table,
           progs, consts, is_composite, active, values, timestamps)
    fn = lib.apply_programs_launch
    args = ((_I * 10)(*layout), W, N, L, K, rep,
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
    _check_layout(layout)
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
