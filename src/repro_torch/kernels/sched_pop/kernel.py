"""Launcher of the CUDA scheduler pop (``csrc/sched_pop.cu``), the Hopper
port of the JAX package's Pallas ``sched_pop_call``.

The pop takes the first ``batch`` slots of one static order, (key,
virtual tag, seq, slot), so one CTA computes it as two sorts of the queue
in shared memory (``csrc/pop_select.cuh``): the first ranks each valid slot
within its tenant, which gives its tag, the second orders the slots by the
full key.  See the note at the top of the source for what bounds it.  The
library is built with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232448     # bytes of shared memory one Hopper CTA may use
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("sched_pop")
    if not getattr(lib, "_typed", False):
        lib.sched_pop_launch.argtypes = [_P] * 8 + [_I] * 3 + [_P] * 6
        lib.sched_pop_launch.restype = _I
        lib._typed = True
    return lib


def smem_bytes(Q: int, batch: int) -> int:
    """Shared memory the pop of a Q-slot queue takes (the layout of
    ``csrc/pop_select.cuh``): per slot a 16-byte sort word, two 16-bit
    entries of the slot lists the sorts permute and the valid byte; per
    pick one int32; 32 int32 for the rank scan."""
    return 21 * Q + 4 * (batch + 32)


def check_fits(Q: int, batch: int) -> None:
    """Raise for a queue whose planes do not fit one CTA's shared memory:
    at most 11,050 slots at batch 64 (``(SMEM_LIMIT - 4 * (batch + 32))
    // 21``), 9,292 at batch == Q; there is no fallback."""
    need = smem_bytes(Q, batch)
    if need > SMEM_LIMIT:
        raise ValueError(f"queue of {Q} slots needs {need} B of shared "
                         f"memory; one CTA holds {SMEM_LIMIT} B")


def _i32(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def _u8(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.bool).contiguous()


def plan_sched_pop(prio, seq, valid, tenant, w_slot, sid, vals, ts,
                   batch: int):
    """Check and stage one pop on the card without launching it: the
    inputs as contiguous int32/bool/float32 tensors on ``vals``' device,
    the outputs allocated.  Returns ``(launch, outputs)``: ``launch()``
    enqueues the kernel on PyTorch's current stream and does no other
    host work, so it can be called again to time the kernel alone;
    ``outputs`` is ``(take, (p_sid, p_vals, p_ts, p_valid))``."""
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError("sched_pop_call takes CUDA tensors")
    Q, C = vals.shape
    if not 0 < batch <= Q:
        raise ValueError(f"batch {batch} outside [1, {Q}]")
    check_fits(Q, batch)
    ins = [_i32(prio, dev), _i32(seq, dev), _u8(valid, dev),
           _i32(tenant, dev), _i32(w_slot, dev), _i32(sid, dev),
           _i32(ts, dev),
           vals.to(device=dev, dtype=torch.float32).contiguous()]
    for t in ins[:-1]:
        if t.shape != (Q,):
            raise ValueError(f"per-slot plane of shape {tuple(t.shape)}, "
                             f"expected ({Q},)")
    take = torch.empty((batch,), dtype=torch.int32, device=dev)
    p_sid = torch.empty_like(take)
    p_ts = torch.empty_like(take)
    p_valid = torch.empty((batch,), dtype=torch.bool, device=dev)
    p_vals = torch.empty((batch, C), dtype=torch.float32, device=dev)
    outs = (take, p_sid, p_ts, p_valid, p_vals)
    fn = _lib().sched_pop_launch
    args = (*[_build.ptr(t) for t in ins], Q, C, batch,
            *[_build.ptr(t) for t in outs], _build.stream_ptr(dev))

    def launch(keep_alive=(ins, outs)):
        _build.check(fn(*args), "sched_pop")

    return launch, (take, (p_sid, p_vals, p_ts, p_valid))


def sched_pop_call(prio, seq, valid, tenant, w_slot, sid, vals, ts,
                   batch: int):
    """Launch the pop kernel on PyTorch's current stream.  All per-slot
    planes are (Q,) int32 (``valid`` bool); ``vals`` is (Q, C) float32,
    on one CUDA device.  Returns ``(take, (p_sid, p_vals, p_ts,
    p_valid))`` — bit-identical to ``ref.sched_pop_ref`` plus gathers.
    Counts one launch in ``sched_pop_call.launches``."""
    launch, out = plan_sched_pop(prio, seq, valid, tenant, w_slot, sid,
                                 vals, ts, batch)
    launch()
    sched_pop_call.launches += 1
    return out


sched_pop_call.launches = 0
