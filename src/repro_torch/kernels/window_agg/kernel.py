"""Launcher of the CUDA window aggregates (``csrc/window_agg.cu``), the
Hopper port of the JAX package's Pallas ``window_agg``.

A grid of 128-thread CTAs, each owning 128 / C streams, stages the
windows chunk by chunk into shared memory with coalesced loads and folds
every (stream, channel) column in index order; see the note at the top
of the source for what bounds it.  Unlike the Pallas kernel, whose
``block_n`` must divide N, it takes any N.  The library is built with
``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_agg.ref import AGGREGATES

THREADS = 128           # threads per CTA; one per (stream, channel)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("window_agg")
    if not getattr(lib, "_typed", False):
        lib.window_agg_launch.argtypes = [_P] * 2 + [_I] * 3 + [_P] * 6
        lib.window_agg_launch.restype = _I
        lib._typed = True
    return lib


def plan_window_agg(values: torch.Tensor, count: torch.Tensor):
    """Check and stage one launch on the card without making it: the
    inputs as contiguous float32/int32 tensors on ``values``' device and
    the five outputs allocated.  Returns ``(launch, outputs)``:
    ``launch()`` enqueues the kernel on PyTorch's current stream and does
    no other host work (so it can be timed alone); ``outputs`` is the
    dict ``window_agg_call`` returns."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError("window_agg_call takes CUDA tensors")
    if values.dim() != 3:
        raise ValueError(f"values of shape {tuple(values.shape)}, "
                         "expected (N, W, C)")
    N, W, C = values.shape
    if N < 1 or W < 1 or not 1 <= C <= THREADS:
        raise ValueError(f"window_agg takes N >= 1, W >= 1 and "
                         f"1 <= C <= {THREADS}; got {(N, W, C)}")
    if count.shape != (N,):
        raise ValueError(f"count of shape {tuple(count.shape)}, "
                         f"expected ({N},)")
    vals = values.to(dtype=torch.float32).contiguous()
    cnt = count.to(device=dev, dtype=torch.int32).contiguous()
    outs = {k: torch.empty((N, C), dtype=torch.float32, device=dev)
            for k in AGGREGATES}
    fn = _lib().window_agg_launch
    args = (_build.ptr(vals), _build.ptr(cnt), N, W, C,
            *[_build.ptr(outs[k]) for k in AGGREGATES],
            _build.stream_ptr(dev))

    def launch(keep_alive=(vals, cnt, outs)):
        _build.check(fn(*args), "window_agg")

    return launch, outs


def window_agg_call(values: torch.Tensor, count: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Launch the window aggregates on PyTorch's current stream.
    ``values`` (N, W, C) float32 ring buffers and ``count`` (N,) int32
    valid entries, on one CUDA device.  Returns the dict of (N, C) float32
    ``sum``/``mean``/``max``/``min``/``count`` — bit-identical to
    ``ref.window_agg_ref``.  Counts one launch in
    ``window_agg_call.launches``."""
    launch, out = plan_window_agg(values, count)
    launch()
    window_agg_call.launches += 1
    return out


window_agg_call.launches = 0
