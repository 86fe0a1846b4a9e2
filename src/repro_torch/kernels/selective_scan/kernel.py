"""Launcher of the CUDA selective scan (``csrc/selective_scan.cu``), the
Hopper port of the JAX package's Pallas ``selective_scan``.

One thread per (batch, channel, state) keeps its carry in a register and
runs the whole sequence; a channel's S states are neighbouring lanes, so
y is a shuffle sum.  See the note at the top of the source for what
bounds it.  ``plan_selective_scan`` checks and stages a launch without
making it; ``selective_scan_call`` plans, launches and counts.  The
library is built with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
STATES = (1, 2, 4, 8, 16, 32)      # S: the lanes of one channel


def _lib():
    lib = _build.load("selective_scan")
    if not getattr(lib, "_typed", False):
        lib.selective_scan_launch.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.selective_scan_launch.restype = _I
        lib._typed = True
    return lib


def plan_selective_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                        h0: torch.Tensor):
    """Check and stage one launch on the card without making it: a, bx
    (B, L, Di, S), c (B, L, S), h0 (B, Di, S) as contiguous float32 on one
    CUDA device.  Returns ``(launch, (y, h_final))``."""
    if not all(t.is_cuda and t.device == a.device for t in (a, bx, c, h0)):
        raise ValueError("selective_scan_call takes CUDA tensors on one "
                         "device")
    if a.dim() != 4 or bx.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and bx {tuple(bx.shape)}: "
                         "expected equal (B, L, Di, S)")
    B, L, Di, S = a.shape
    if c.shape != (B, L, S) or h0.shape != (B, Di, S):
        raise ValueError(f"c {tuple(c.shape)}, h0 {tuple(h0.shape)}: "
                         f"expected {(B, L, S)}, {(B, Di, S)}")
    if S not in STATES or min(B, L, Di) < 1:
        raise ValueError(f"selective_scan takes S in {STATES} and non-empty "
                         f"B, L, Di; got {tuple(a.shape)}")
    a, bx, c, h0 = (t.to(torch.float32).contiguous() for t in (a, bx, c, h0))
    y = torch.empty((B, L, Di), dtype=torch.float32, device=a.device)
    h = torch.empty((B, Di, S), dtype=torch.float32, device=a.device)
    fn = _lib().selective_scan_launch
    args = (*(_build.ptr(t) for t in (a, bx, c, h0, y, h)), B, L, Di, S,
            _build.stream_ptr(a.device))

    def launch(keep_alive=(a, bx, c, h0, y, h)):
        _build.check(fn(*args), "selective_scan")

    return launch, (y, h)


def selective_scan_call(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                        h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence on the card: returns y (B, L, Di) and the final
    state (B, Di, S), float32.  Counts one launch in
    ``selective_scan_call.launches``."""
    launch, out = plan_selective_scan(a, bx, c, h0)
    launch()
    selective_scan_call.launches += 1
    return out


selective_scan_call.launches = 0
