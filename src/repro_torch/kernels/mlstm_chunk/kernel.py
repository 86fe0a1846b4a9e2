"""Launcher of the CUDA chunkwise mLSTM (``csrc/mlstm_chunk.cu``), the
Hopper port of the JAX package's Pallas ``mlstm_chunkwise``.

The Pallas kernel keeps the (Dh, Dh) matrix memory in VMEM for the whole
sequence; at Dh 1024 that is 4 MB, far beyond a CTA's shared memory, so
the kernel here is four launches: the gates over the sequence, the state
carried chunk by chunk in 64 x 64 tiles (every chunk's starting state is
written out), the masked, stabilised score tiles of each chunk, and the
output tiles.  See the note at the top of the source for what bounds it.
``plan_mlstm_chunkwise`` checks and stages a call (inputs, outputs and
scratch) without launching; ``mlstm_chunkwise_call`` plans, launches and
counts.  The library is built with ``nvcc`` at the first call
(``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
LAUNCHES_PER_CALL = 4        # gate, state, intra, out
KERNEL_NAMES = ("mlstm_gate_kernel", "mlstm_state_kernel",
                "mlstm_intra_kernel", "mlstm_out_kernel")


def _lib():
    lib = _build.load("mlstm_chunk")
    if not getattr(lib, "_typed", False):
        lib.mlstm_chunk_launch.argtypes = (
            [_P] * 15 + [_I] * 4 + [ctypes.c_float, _P, _I])
        lib.mlstm_chunk_launch.restype = _I
        lib._typed = True
    return lib


def plan_mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_raw: torch.Tensor, f_raw: torch.Tensor, *,
                         chunk: int = 256):
    """Check and stage one call on the card without launching it: q, k,
    v (B, H, L, Dh) with Dh a multiple of 4 and i_raw, f_raw (B, H, L) on
    one CUDA device, any float dtype (cast to contiguous float32); chunks
    of ``min(chunk, L)`` positions, the last one possibly shorter.
    Returns ``(launch, (h, (C, n, m)))``: ``launch()`` enqueues the four
    kernels on PyTorch's current stream and does no other host work;
    ``launch(i)`` enqueues only kernel i of ``KERNEL_NAMES`` (to time it
    alone, after a full launch has filled its inputs)."""
    ts = (q, k, v, i_raw, f_raw)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("mlstm_chunkwise_call takes CUDA tensors on one "
                         "device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected equal (B, H, L, Dh)")
    B, H, L, Dh = q.shape
    if i_raw.shape != (B, H, L) or f_raw.shape != (B, H, L):
        raise ValueError(f"i_raw {tuple(i_raw.shape)}, f_raw "
                         f"{tuple(f_raw.shape)}: expected {(B, H, L)}")
    if min(B, H, L) < 1 or Dh < 4 or Dh % 4 or chunk < 1:
        raise ValueError(f"mlstm_chunkwise takes non-empty B, H, L, Dh a "
                         f"multiple of 4 and chunk >= 1; got "
                         f"{tuple(q.shape)}, chunk {chunk}")
    ck = min(chunk, L)
    nc = -(-L // ck)
    BH = B * H
    if nc * BH > 65535:
        raise ValueError(f"{nc} chunks x {BH} heads exceed the grid")
    q, k, v, i_raw, f_raw = (t.to(torch.float32).contiguous() for t in ts)
    dev = q.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h, C, n, m = empty(B, H, L, Dh), empty(B, H, Dh, Dh), empty(B, H, Dh), \
        empty(B, H)
    scratch = (empty(4, BH, L), empty(BH, nc + 1), empty(BH, nc),
               empty(BH, max(nc - 1, 1), Dh, Dh), empty(BH, max(nc - 1, 1), Dh),
               empty(BH, nc, ck, ck))
    fn = _lib().mlstm_chunk_launch
    args = (*(_build.ptr(t) for t in (q, k, v, i_raw, f_raw, h, C, n, m)),
            *(_build.ptr(t) for t in scratch), BH, L, Dh, ck, Dh ** -0.5,
            _build.stream_ptr(dev))

    def launch(stage=-1, keep_alive=(q, k, v, i_raw, f_raw, h, C, n, m,
                                     scratch)):
        _build.check(fn(*args, stage), "mlstm_chunkwise")

    return launch, (h, (C, n, m))


def mlstm_chunkwise_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_raw: torch.Tensor, f_raw: torch.Tensor, *,
                         chunk: int = 256
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The chunkwise mLSTM from the zero state on the card: h (B, H, L,
    Dh) and the final (C, n, m), float32 (see
    :func:`plan_mlstm_chunkwise`).  Adds its four CUDA launches to
    ``mlstm_chunkwise_call.launches``."""
    launch, out = plan_mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk=chunk)
    launch()
    mlstm_chunkwise_call.launches += LAUNCHES_PER_CALL
    return out


mlstm_chunkwise_call.launches = 0
