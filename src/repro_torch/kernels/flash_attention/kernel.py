"""Launcher of the CUDA flash attention (``csrc/flash_attention.cu``), the
Hopper port of the JAX package's Pallas ``flash_attention``.

bf16 runs on the tensor cores (wgmma products, TMA tiles; see the note at
the top of the source); float32 runs the scalar body.  q, k, v are read
in place through their strides, so the model plane's (B, L, H, Dh)
tensors (and transposed views of (B, H, L, Dh) ones) launch without a
copy; a bf16 input whose base or strides break TMA's 16-byte rules is
copied first (:func:`reads_in_place`, :func:`tma_operand`).
``plan_*`` checks and stages a launch without making it (so it can be
timed alone); ``flash_attention_call`` plans, launches and counts.  The
library is built with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 256
TMA_ALIGN = 16                  # bytes: TMA's rule for bases and strides


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P, _P])
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_bf16_smem.argtypes = [_I]
        lib.flash_attention_bf16_smem.restype = _I
        lib._typed = True
    return lib


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA can read a (B, L, heads, Dh) operand
    where it lies: a contiguous head dim, a base aligned to 16 bytes, and
    the outer dims of size > 1, ordered by stride, each with a stride that
    is a multiple of 16 bytes and spans at least the dims inside it (no
    overlap, no negative strides).  The kernel's host code encodes its
    tensor maps by the same rules."""
    if t.dim() != 4 or (t.shape[3] > 1 and t.stride(3) != 1):
        return False
    item = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        return False
    extent = t.shape[3] * item          # bytes spanned by the dims inside
    outer = sorted((t.stride(d) * item, t.shape[d]) for d in range(3)
                   if t.shape[d] > 1)
    for stride, size in outer:
        if stride % TMA_ALIGN or stride < extent:
            return False
        extent = stride * size
    return True


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where :func:`reads_in_place` holds, else a copy in a
    new (B, L, heads, Dh8) buffer with Dh8 = Dh rounded up to 8, returned
    as its (B, L, heads, Dh) view: the padding is never read (TMA
    zero-fills past Dh)."""
    if reads_in_place(t):
        return t
    B, L, n, Dh = t.shape
    buf = torch.empty((B, L, n, -(-Dh // 8) * 8), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :Dh]
    view.copy_(t)
    return view


def plan_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: Optional[int] = None):
    """Check and stage one launch on the card without making it.  q, k,
    v are (B, Lq, H, Dh), (B, S, KV, Dh), float32 or bf16 on one CUDA
    device, any strides (float32: a head dim that is not contiguous is
    copied; bf16: what :func:`reads_in_place` refuses is copied).
    Returns ``(launch, out)``: ``launch()`` enqueues the kernel on
    PyTorch's current stream and does no other host work; ``out`` is a
    new contiguous tensor of q's shape and dtype."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_call takes CUDA tensors on one "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype of {list(DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected 4-D q and k == v")
    B, Lq, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form grouped-query attention")
    if not 1 <= Dh <= MAX_DH or Lq < 1 or S < 1:
        raise ValueError(f"flash_attention takes 1 <= Dh <= {MAX_DH} and "
                         f"non-empty sequences; got Dh {Dh}, Lq {Lq}, S {S}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(t) for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out)
        for s in (t.stride(0), t.stride(2), t.stride(1))])
    fn = _lib().flash_attention_launch
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            DTYPES[q.dtype], B, H, KV, Lq, S, Dh,
            0 if window is None else int(window), Dh ** -0.5,
            ctypes.cast(strides, _P), _build.stream_ptr(q.device))

    def launch(keep_alive=(q, k, v, out, strides)):
        _build.check(fn(*args), "flash_attention")

    return launch, out


def bf16_smem_bytes(Dh: int) -> int:
    """Dynamic shared memory of the bf16 kernel's CTA at head dim Dh."""
    return _lib().flash_attention_bf16_smem(Dh)


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention on the card,
    (B, Lq, H, Dh) in q's dtype (see :func:`plan_flash_attention`).
    Counts one launch in ``flash_attention_call.launches``."""
    launch, out = plan_flash_attention(q, k, v, window=window)
    launch()
    flash_attention_call.launches += 1
    return out


flash_attention_call.launches = 0
