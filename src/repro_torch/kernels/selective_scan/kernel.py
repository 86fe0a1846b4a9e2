"""Launcher of the CUDA selective scan (``csrc/selective_scan.cu``), the
Hopper port of the JAX package's Pallas ``selective_scan``.

A thread keeps four neighbouring states of one channel (one state where
S < 4 or a base is not 16-byte aligned) in registers for the whole
sequence; a channel's lanes sum y by shuffles.  Long sequences stream
through a ring of shared memory fed by 1-D bulk copies, chunk by chunk;
short ones (decode's L = 1) load straight into registers.  See the note at
the top of the source for what bounds it.  :func:`selective_scan_plan` is
the one place that decides the path, the template and the CTA shape; the
launcher passes its plan to the source, which checks it.
``plan_selective_scan`` checks and stages a launch without making it;
``selective_scan_call`` plans, launches and counts.  The library is built
with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
STATES = (1, 2, 4, 8, 16, 32)      # S: the states of one channel
RING_STEPS = 8                     # steps a chunk of the ring (kT)
RING_STAGES = 3                    # ring stages (kStages)
RING_OFFSET = 128                  # shared bytes before the ring: mbarriers
RING_FLOATS = 512                  # floats of a ring row: C S (2 KB)
REGISTER_THREADS = 256             # the register path's CTA
SMS = 132                          # streaming multiprocessors (H100 SXM)
SMEM_LIMIT = 232448                # dynamic shared bytes a CTA may opt in to


class SelectiveScanPlan(NamedTuple):
    """One launch of the selective scan."""
    path: str             # "ring" (bulk copies into shared memory) or
                          # "register" (loads straight into registers)
    states: int           # states a thread: 4 or 1 (the two templates)
    channels: int         # channels a CTA
    threads: int          # threads a CTA: channels S / states
    grid: Tuple[int, int]  # (channel blocks, B)
    smem_bytes: int       # dynamic shared bytes a CTA (0 on the register path)


def ring_smem_bytes(S: int, channels: int) -> int:
    """Shared bytes of a ring CTA: the mbarriers, RING_STAGES stages of a
    and bx (RING_STEPS rows of channels S floats each) and c (RING_STEPS S
    floats), and two y buffers of RING_STEPS channels floats."""
    T = RING_STEPS
    return RING_OFFSET + 4 * (RING_STAGES * (2 * T * channels * S + T * S)
                              + 2 * T * channels)


def selective_scan_plan(B: int, L: int, Di: int, S: int,
                        aligned: bool = True) -> SelectiveScanPlan:
    """The plan of one launch at (B, L, Di, S) whose a, bx, c and h0 are
    all 16-byte aligned where ``aligned``.

    Four states a thread where S >= 4 and the bases are aligned, else one.
    With four states, L >= RING_STEPS takes the ring path: rows of
    C S = 512 floats (128 threads, two CTAs an SM), halved (64 threads,
    four an SM) where fewer CTAs than SMs would run, so every SM streams.
    Everything else takes the register path: CTAs of 256 threads,
    S / states lanes a channel."""
    if S not in STATES or min(B, L, Di) < 1:
        raise ValueError(f"selective_scan takes S in {STATES} and non-empty "
                         f"B, L, Di; got {(B, L, Di, S)}")
    if B > 65535:
        raise ValueError(f"selective_scan takes B <= 65535 (the grid's "
                         f"second dimension); got {B}")
    states = 4 if S >= 4 and aligned else 1
    if states == 4 and L >= RING_STEPS:
        C = RING_FLOATS // S
        if B * -(-Di // C) < SMS:
            C //= 2
        smem = ring_smem_bytes(S, C)
        assert smem <= SMEM_LIMIT
        return SelectiveScanPlan("ring", 4, C, C * S // 4,
                                 (-(-Di // C), B), smem)
    C = REGISTER_THREADS // (S // states)
    return SelectiveScanPlan("register", states, C, REGISTER_THREADS,
                             (-(-Di // C), B), 0)


def _lib():
    lib = _build.load("selective_scan")
    if not getattr(lib, "_typed", False):
        lib.selective_scan_launch.argtypes = [_P] * 6 + [_I] * 8 + [_P]
        lib.selective_scan_launch.restype = _I
        lib._typed = True
    return lib


def plan_selective_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                        h0: torch.Tensor):
    """Check and stage one launch on the card without making it: a, bx
    (B, L, Di, S), c (B, L, S), h0 (B, Di, S) as contiguous float32 on one
    CUDA device.  Returns ``(launch, (y, h_final))``; ``launch.plan`` is
    the :func:`selective_scan_plan` it launches."""
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
    plan = selective_scan_plan(B, L, Di, S, all(
        t.data_ptr() % 16 == 0 for t in (a, bx, c, h0)))
    y = torch.empty((B, L, Di), dtype=torch.float32, device=a.device)
    h = torch.empty((B, Di, S), dtype=torch.float32, device=a.device)
    fn = _lib().selective_scan_launch
    # ints as c_int objects: ctypes passes them without converting each
    # call (~1 us less host time a launch, which the decode step pays)
    ints = (B, L, Di, S, plan.path == "ring", plan.states, plan.channels,
            plan.smem_bytes)
    args = (*(_build.ptr(t) for t in (a, bx, c, h0, y, h)),
            *(_I(int(v)) for v in ints), _build.stream_ptr(a.device))

    def launch(keep_alive=(a, bx, c, h0, y, h)):
        _build.check(fn(*args), "selective_scan")

    launch.plan = plan
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
