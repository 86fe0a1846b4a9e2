"""Launcher of the CUDA chunkwise mLSTM (``csrc/mlstm_chunk.cu``), the
Hopper port of the JAX package's Pallas ``mlstm_chunkwise``.

The Pallas kernel keeps the (Dh, Dh) matrix memory in VMEM for the whole
sequence; at Dh 1024 that is 4 MB, far beyond a CTA's shared memory, so
the kernel here is five launches: the gates over the sequence, the bf16
pieces of the products' operands, the state carried chunk by chunk in
128 x 128 tiles (every chunk's starting state is written out), the
masked, stabilised score tiles of each chunk, and the output tiles.  The
products run on the tensor cores (wgmma on TMA tiles) with every operand
that is not bf16-exact split into three bf16 pieces (:func:`bf16_pieces`);
bf16 q, k, v are exact and are read as they are.  See the note at the top
of the source for what bounds it.  ``plan_mlstm_chunkwise`` checks and
stages a call (inputs, outputs and scratch) without launching;
``mlstm_chunkwise_call`` plans, launches and counts.  The library is built
with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
LAUNCHES_PER_CALL = 5        # gate, prep, state, intra, out
KERNEL_NAMES = ("mlstm_gate_kernel", "mlstm_prep_kernel", "mlstm_state_kernel",
                "mlstm_intra_kernel", "mlstm_out_kernel")
TMA_ALIGN = 16               # bytes: TMA's rule for bases and strides
TILE = 128                   # the kernel's row tile (S.D is padded to it)
PREP_GROUPS = 4              # csrc's kPrepGroups: row groups of a chunk


def _lib():
    lib = _build.load("mlstm_chunk")
    if not getattr(lib, "_typed", False):
        lib.mlstm_chunk_launch.argtypes = (
            [_P] * 21 + [_I] * 6 + [ctypes.c_float, _P, _I])
        lib.mlstm_chunk_launch.restype = _I
        lib.mlstm_chunk_smem.argtypes = []
        lib.mlstm_chunk_smem.restype = _I
        lib._typed = True
    return lib


def bf16_pieces(x: torch.Tensor, n: int = 3) -> Tuple[torch.Tensor, ...]:
    """``x`` (float32) as ``n`` bf16 pieces, as the CUDA code makes them:
    piece i is the round-to-nearest bf16 of what the pieces before it
    leave of x, a remainder that is exact in float32.  Three pieces hold
    x to 2^-24 |x|; a bf16-exact x has one nonzero piece."""
    rest = x.to(torch.float32)
    out = []
    for _ in range(n):
        p = rest.to(torch.bfloat16)
        out.append(p)
        rest = rest - p.to(torch.float32)
    return tuple(out)


def input_layout(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(rs, mb, mh)`` such that element (b, h, row, d) of the (B, H, L,
    Dh) tensor ``t`` lies at ((b mb + h mh) L + row) rs + d, or None: a
    contiguous head dim, rows rs >= Dh apart, and the B H matrices dense,
    batch outermost (mb = H, mh = 1) or heads outermost (mb = 1, mh = B,
    the layout an einsum over heads leaves)."""
    B, H, L, Dh = t.shape
    if Dh > 1 and t.stride(3) != 1:
        return None
    rs = t.stride(2)
    if rs < Dh:
        return None
    mat = L * rs
    for mb, mh in ((H, 1), (1, B)):
        if (B == 1 or t.stride(0) == mb * mat) and \
                (H == 1 or t.stride(1) == mh * mat):
            return rs, mb, mh
    return None


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel's TMA can read a bf16 (B, H, L, Dh) operand where
    it lies: an :func:`input_layout`, rows a multiple of 16 bytes apart
    and a base aligned to 16 bytes."""
    lay = input_layout(t)
    return lay is not None and (lay[0] * t.element_size()) % TMA_ALIGN == 0 \
        and t.data_ptr() % TMA_ALIGN == 0


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where :func:`reads_in_place` holds, else a copy in a
    new (B, H, L, Dh8) buffer with Dh8 = Dh rounded up to 8, returned as
    its (B, H, L, Dh) view: the padding is never read (TMA zero-fills past
    Dh)."""
    if reads_in_place(t):
        return t
    B, H, L, Dh = t.shape
    buf = torch.empty((B, H, L, -(-Dh // 8) * 8), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :Dh]
    view.copy_(t)
    return view


def _float32_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32 in an :func:`input_layout` with rows a multiple
    of 16 bytes apart on a 16-byte aligned base (the kernel reads four
    columns a load), copied where it is not."""
    t = t.to(torch.float32)
    lay = input_layout(t)
    if lay is None or lay[0] % 4 or t.data_ptr() % TMA_ALIGN:
        return t.contiguous()
    return t


def plan_mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_raw: torch.Tensor, f_raw: torch.Tensor, *,
                         chunk: int = 256):
    """Check and stage one call on the card without launching it: q, k,
    v (B, H, L, Dh) with Dh a multiple of 4 and i_raw, f_raw (B, H, L) on
    one CUDA device.  bf16 q, k, v are read as they are (copied first where
    :func:`reads_in_place` refuses them); any other float dtype is cast to
    float32 and split into bf16 pieces by the kernel.  Chunks of
    ``min(chunk, L)`` positions, the last one possibly shorter.  Returns
    ``(launch, (h, (C, n, m)))``, all float32: ``launch()`` enqueues the
    five kernels on PyTorch's current stream and does no other host work;
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
    if max(nc * BH, nc * PREP_GROUPS) > 65535:
        raise ValueError(f"{nc} chunks x {BH} heads exceed the grid")
    bf16 = all(t.dtype == torch.bfloat16 for t in (q, k, v))
    prep = tma_operand if bf16 else _float32_operand
    q, k, v = (prep(t) for t in (q, k, v))
    i_raw, f_raw = (t.to(torch.float32).contiguous() for t in (i_raw, f_raw))
    dev = q.device
    ckp = -(-ck // TILE) * TILE
    d8 = -(-Dh // 8) * 8
    n1 = max(nc - 1, 1)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    h, C, n, m = empty(B, H, L, Dh), empty(B, H, Dh, Dh), empty(B, H, Dh), \
        empty(B, H)
    b16 = torch.bfloat16
    scratch = (empty(4, BH, L), empty(BH, nc + 1), empty(BH, nc),
               empty(1, dtype=b16) if bf16 else empty(9, BH, L, d8, dtype=b16),
               empty(3, BH, nc * ckp, d8, dtype=b16),
               empty(BH, nc, PREP_GROUPS, Dh),
               empty(BH, n1, Dh), empty(3, BH * n1, Dh, d8, dtype=b16),
               empty(3, BH * nc, ckp, ckp, dtype=b16),
               empty(ckp // TILE, BH, L), empty(BH, L))
    lay = (ctypes.c_longlong * 9)(*(x for t in (q, k, v)
                                    for x in input_layout(t)))
    fn = _lib().mlstm_chunk_launch
    args = (*(_build.ptr(t) for t in (q, k, v)), ctypes.cast(lay, _P),
            *(_build.ptr(t) for t in (i_raw, f_raw, h, C, n, m)),
            *(_build.ptr(t) for t in scratch), int(bf16), B, H, L, Dh, ck,
            Dh ** -0.5, _build.stream_ptr(dev))

    def launch(stage=-1, keep_alive=(q, k, v, lay, i_raw, f_raw, h, C, n, m,
                                     scratch)):
        _build.check(fn(*args, stage), "mlstm_chunkwise")

    return launch, (h, (C, n, m))


def smem_bytes() -> int:
    """Dynamic shared memory of a CTA of the product kernels (state,
    intra, out)."""
    return _lib().mlstm_chunk_smem()


def mlstm_chunkwise_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_raw: torch.Tensor, f_raw: torch.Tensor, *,
                         chunk: int = 256
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The chunkwise mLSTM from the zero state on the card: h (B, H, L,
    Dh) and the final (C, n, m), float32 (see
    :func:`plan_mlstm_chunkwise`).  Adds its five CUDA launches to
    ``mlstm_chunkwise_call.launches``."""
    launch, out = plan_mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk=chunk)
    launch()
    mlstm_chunkwise_call.launches += LAUNCHES_PER_CALL
    return out


mlstm_chunkwise_call.launches = 0
