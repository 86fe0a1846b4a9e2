"""Launchers of the CUDA stream-dispatch kernels
(``csrc/stream_dispatch.cu``), the Hopper port of the JAX package's
Pallas ``onehot_gather`` and of the ``stream_dispatch`` op built on it.

Both kernels run one thread per output element and load rows directly;
see the note at the top of the source for what bounds them.  ``plan_*``
checks and stages a launch without making it (so it can be timed
alone); the ``*_call`` wrappers plan, launch and count.  The library is
built with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("stream_dispatch")
    if not getattr(lib, "_typed", False):
        lib.onehot_gather_launch.argtypes = [_P] * 2 + [_I] * 4 + [_P] * 2
        lib.onehot_gather_launch.restype = _I
        lib.stream_dispatch_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P] * 3
        lib.stream_dispatch_launch.restype = _I
        lib._typed = True
    return lib


def _i32(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def plan_onehot_gather(table: torch.Tensor, ids: torch.Tensor):
    """Check and stage one gather on the card without launching it.
    Returns ``(launch, out)``: ``launch()`` enqueues the kernel on
    PyTorch's current stream and does no other host work; ``out`` is the
    (M, F) float32 result."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("onehot_gather_call takes CUDA tensors")
    if table.dim() != 2 or table.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"table of shape {tuple(table.shape)} and "
                         f"{table.dtype}, expected (N, F) int32 or float32")
    if ids.dim() != 1:
        raise ValueError(f"ids of shape {tuple(ids.shape)}, expected (M,)")
    (N, F), M = table.shape, ids.shape[0]
    if N < 1 or F < 1 or M < 1:
        raise ValueError(f"onehot_gather takes N, F, M >= 1; got "
                         f"{(N, F, M)}")
    tab = table.contiguous()
    idx = _i32(ids, dev)
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    fn = _lib().onehot_gather_launch
    args = (_build.ptr(tab), _build.ptr(idx), N, F, M,
            int(table.dtype == torch.int32), _build.ptr(out),
            _build.stream_ptr(dev))

    def launch(keep_alive=(tab, idx, out)):
        _build.check(fn(*args), "onehot_gather")

    return launch, out


def onehot_gather_call(table: torch.Tensor, ids: torch.Tensor
                       ) -> torch.Tensor:
    """Launch the row gather on PyTorch's current stream: ``table`` (N, F)
    int32 or float32 and ``ids`` (M,) on one CUDA device -> (M, F)
    float32, zero rows for ids outside [0, N) — bit-identical to
    ``ref.onehot_gather_ref``.  Counts one launch in
    ``onehot_gather_call.launches``."""
    launch, out = plan_onehot_gather(table, ids)
    launch()
    onehot_gather_call.launches += 1
    return out


onehot_gather_call.launches = 0


def plan_stream_dispatch(sid, ts, valid, out_table, timestamps, *,
                         with_early: bool = True):
    """Check and stage one fan-out on the card without launching it.
    Returns ``(launch, (targets, early))`` with ``early`` None unless
    ``with_early``."""
    dev = out_table.device
    if dev.type != "cuda":
        raise ValueError("stream_dispatch_call takes CUDA tensors")
    if out_table.dim() != 2 or timestamps.dim() != 1:
        raise ValueError(f"out_table of shape {tuple(out_table.shape)} and "
                         f"timestamps of shape {tuple(timestamps.shape)}, "
                         "expected (n_tab, F) and (N,)")
    (n_tab, F), N, B = out_table.shape, timestamps.shape[0], sid.shape[0]
    if n_tab < 1 or F < 1 or B < 1:
        raise ValueError(f"stream_dispatch takes n_tab, F, B >= 1; got "
                         f"{(n_tab, F, B)}")
    if sid.shape != (B,) or ts.shape != (B,) or valid.shape != (B,):
        raise ValueError(f"sid/ts/valid of shapes {tuple(sid.shape)}, "
                         f"{tuple(ts.shape)}, {tuple(valid.shape)}, "
                         f"expected ({B},)")
    ins = (_i32(sid, dev), _i32(ts, dev),
           valid.to(device=dev, dtype=torch.bool).contiguous(),
           _i32(out_table, dev), _i32(timestamps, dev))
    targets = torch.empty((B, F), dtype=torch.int32, device=dev)
    early = torch.empty((B, F), dtype=torch.bool, device=dev) \
        if with_early else None
    fn = _lib().stream_dispatch_launch
    args = (*[_build.ptr(t) for t in ins], B, F, n_tab, N, int(with_early),
            _build.ptr(targets),
            _build.ptr(early) if with_early else None,
            _build.stream_ptr(dev))

    def launch(keep_alive=(ins, targets, early)):
        _build.check(fn(*args), "stream_dispatch")

    return launch, (targets, early)


def stream_dispatch_call(sid, ts, valid, out_table, timestamps, *,
                         with_early: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the fan-out on PyTorch's current stream: sid/ts (B,) int32,
    valid (B,) bool, out_table (n_tab, F) int32, timestamps (N,) int32,
    on one CUDA device.  Returns ``(targets, early)`` — bit-identical to
    ``ref.stream_dispatch_ref``.  Counts one launch in
    ``stream_dispatch_call.launches``."""
    launch, out = plan_stream_dispatch(sid, ts, valid, out_table,
                                       timestamps, with_early=with_early)
    launch()
    stream_dispatch_call.launches += 1
    return out


stream_dispatch_call.launches = 0
