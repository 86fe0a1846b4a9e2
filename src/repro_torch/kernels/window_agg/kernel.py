"""Launcher of the CUDA window aggregates (``csrc/window_agg.cu``), the
Hopper port of the JAX package's Pallas ``window_agg``.

One-warp CTAs, each owning the (stream, channel) columns of 32 / C
streams (a stream of more than 32 channels spans several warps), stage
their streams' valid prefixes chunk by chunk into a ring of shared memory
ahead of the fold, by 1-D bulk copies where the addresses allow it and by
per-lane asynchronous copies elsewhere; see the note at the top of the
source for what bounds it.  :func:`window_agg_plan` is the one place
that decides the staging, the CTA shape and the shared bytes; the
launcher passes its plan to the source, which checks it.  Unlike the
Pallas kernel, whose ``block_n`` must divide N, it takes any N.  The
library is built with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_agg.ref import AGGREGATES

STAGES = 3              # ring stages per warp (kStages)
RING_OFFSET = 160       # shared bytes before the ring: 4 mbarriers, 32 counts
STAGE_BYTES = 8192      # a stage's target size: G rows of `chunk` entries
MAX_CHUNK = 64          # entries per chunk at most
SMEM_LIMIT = 232448     # dynamic shared bytes one CTA may opt in to (H100)
STAGINGS = ("bulk", "load4")      # the source's Staging codes
_P, _I = ctypes.c_void_p, ctypes.c_int


class WindowAggPlan(NamedTuple):
    """One launch of the window aggregates: how each warp stages its
    streams' windows and how many one-warp CTAs run."""
    staging: str          # "bulk" or "load4"
    chunk: int            # entries per chunk, a multiple of 4
    pitch: int            # bytes per ring row: 16 mod 128
    streams_per_warp: int
    warps_per_stream: int
    blocks: int           # one-warp CTAs
    smem_bytes: int       # dynamic shared bytes per CTA


def window_agg_plan(N: int, W: int, C: int, aligned: bool = True
                    ) -> WindowAggPlan:
    """The plan of one launch on an (N, W, C) store whose base address is
    16-byte aligned where ``aligned``.

    The staging is 1-D bulk copies wherever they may run (a ring row of
    W C floats a multiple of 16 bytes on an aligned base), else 4-byte
    per-lane copies.  A warp owns G = 32 // min(C, 32) streams and a
    stream ceil(C / 32) warps; a chunk is the largest multiple of 4
    entries up to 64 (and up to W rounded up to 4) whose G rows fill
    about 8 KB; a ring row's pitch is the chunk's bytes rounded up to 16
    and then to 16 mod 128 (so the 32 lanes of a fold step at C = 4 read
    32 banks)."""
    if N < 1 or W < 1 or C < 1:
        raise ValueError(f"window_agg takes N, W, C >= 1; got {(N, W, C)}")
    mode = "bulk" if aligned and (W * C) % 4 == 0 else "load4"
    cw = min(C, 32)
    G = 32 // cw
    parts = -(-C // 32)
    chunk = STAGE_BYTES // (G * C * 4) // 4 * 4
    chunk = max(4, min(chunk, MAX_CHUNK, -(-W // 4) * 4))
    pitch = -(-chunk * C * 4 // 16) * 16
    pitch += (16 - pitch % 128) % 128
    smem = RING_OFFSET + STAGES * G * pitch
    if smem > SMEM_LIMIT:
        raise ValueError(f"C = {C} needs {smem} shared bytes per warp; one "
                         f"CTA holds at most {SMEM_LIMIT}")
    return WindowAggPlan(mode, chunk, pitch, G, parts, -(-N // G) * parts,
                         smem)


def _lib():
    lib = _build.load("window_agg")
    if not getattr(lib, "_typed", False):
        lib.window_agg_launch.argtypes = [_P] * 2 + [_I] * 10 + [_P] * 6
        lib.window_agg_launch.restype = _I
        lib._typed = True
    return lib


def plan_window_agg(values: torch.Tensor, count: torch.Tensor):
    """Check and stage one launch on the card without making it: the
    inputs as contiguous float32/int32 tensors on ``values``' device, the
    five outputs allocated and the :func:`window_agg_plan`.  Returns ``(launch, outputs)``: ``launch()`` enqueues the
    kernel on PyTorch's current stream and does no other host work (so
    it can be timed alone); ``outputs`` is the dict ``window_agg_call``
    returns."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError("window_agg_call takes CUDA tensors")
    if values.dim() != 3:
        raise ValueError(f"values of shape {tuple(values.shape)}, "
                         "expected (N, W, C)")
    N, W, C = values.shape
    if count.shape != (N,):
        raise ValueError(f"count of shape {tuple(count.shape)}, "
                         f"expected ({N},)")
    vals = values.to(dtype=torch.float32).contiguous()
    cnt = count.to(device=dev, dtype=torch.int32).contiguous()
    plan = window_agg_plan(N, W, C, vals.data_ptr() % 16 == 0)
    outs = {k: torch.empty((N, C), dtype=torch.float32, device=dev)
            for k in AGGREGATES}
    fn = _lib().window_agg_launch
    args = (_build.ptr(vals), _build.ptr(cnt), N, W, C, plan.chunk,
            plan.pitch, plan.streams_per_warp, plan.warps_per_stream,
            STAGINGS.index(plan.staging), plan.blocks, plan.smem_bytes,
            *[_build.ptr(outs[k]) for k in AGGREGATES],
            _build.stream_ptr(dev))

    def launch(keep_alive=(vals, cnt, outs)):
        _build.check(fn(*args), "window_agg")

    launch.plan = plan
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
