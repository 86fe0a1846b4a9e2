"""Launchers of the CUDA stream-dispatch kernels
(``csrc/stream_dispatch.cu``), the Hopper port of the JAX package's
Pallas ``onehot_gather`` and of the ``stream_dispatch`` op built on it.

Both kernels load rows directly, one thread per output element or
16-byte word; see the note at the top of the source for what bounds
them.  The gather kernel serves two wrappers: ``onehot_gather_call``
(one table) and ``by_sid_snapshot_call`` (the sharded round's by-sid
values and timestamps, read from the S shards' planes in place).  ``plan_*``
checks and stages a launch without making it (so it can be timed
alone); the ``*_call`` wrappers plan, launch and count.  The library is
built with ``nvcc`` at the first call (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


MAX_TABLES = 64         # shards a snapshot reads in place (kMaxTables)


def _lib():
    lib = _build.load("stream_dispatch")
    if not getattr(lib, "_typed", False):
        lib.onehot_gather_launch.argtypes = \
            [_P] * 2 + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 3
        lib.onehot_gather_launch.restype = _I
        lib.stream_dispatch_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P] * 3
        lib.stream_dispatch_launch.restype = _I
        lib._typed = True
    return lib


def _i32(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def word_lanes(F: int, addresses) -> int:
    """32-bit lanes a word of the gather moves: 4 (a 16-byte word) or 2
    where the row width ``F`` and every table address allow, else 1."""
    for vec in (4, 2):
        if F % vec == 0 and all(a % (4 * vec) == 0 for a in addresses):
            return vec
    return 1


def _plan_gather(what: str, tables, stamps, ids):
    """Check and stage one launch of the gather kernel over the flat row
    space of the S (L, F) ``tables`` (and their (L,) ``stamps``, or None).
    Returns ``(launch, out, out_ts)``."""
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    S = len(tables)
    if not 1 <= S <= MAX_TABLES:
        raise ValueError(f"{what} reads 1 to {MAX_TABLES} tables in place; "
                         f"got {S}")
    shape, dtype = tuple(tables[0].shape), tables[0].dtype
    if len(shape) != 2 or dtype not in (torch.int32, torch.float32):
        raise ValueError(f"table of shape {shape} and {dtype}, expected "
                         "(L, F) int32 or float32")
    if any(t.shape != shape or t.dtype != dtype or t.device != dev
           for t in tables):
        raise ValueError(f"{what}: the tables differ in shape, dtype or "
                         "device")
    if ids.dim() != 1:
        raise ValueError(f"ids of shape {tuple(ids.shape)}, expected (M,)")
    (L, F), M = shape, ids.shape[0]
    if L < 1 or F < 1 or M < 1:
        raise ValueError(f"{what} takes L, F, M >= 1; got {(L, F, M)}")
    tabs = [t.contiguous() for t in tables]
    if stamps is not None:
        if len(stamps) != S or any(
                t.shape != (L,) or t.dtype != torch.int32 or t.device != dev
                for t in stamps):
            raise ValueError(f"{what}: expected {S} timestamp planes of "
                             f"shape ({L},) int32")
        stamps = [t.contiguous() for t in stamps]
    idx = _i32(ids, dev)
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    out_ts = None if stamps is None else \
        torch.empty((M,), dtype=torch.int32, device=dev)
    rows = (_P * S)(*[t.data_ptr() for t in tabs])
    ts = None if stamps is None else \
        (_P * S)(*[t.data_ptr() for t in stamps])
    vec = word_lanes(F, [t.data_ptr() for t in tabs])
    fn = _lib().onehot_gather_launch
    args = (rows, ts, S, L, F, _build.ptr(idx), M,
            int(dtype == torch.int32), vec, _build.ptr(out),
            None if out_ts is None else _build.ptr(out_ts),
            _build.stream_ptr(dev))

    def launch(keep_alive=(tabs, stamps, idx, out, out_ts)):
        _build.check(fn(*args), what)

    return launch, out, out_ts


def plan_onehot_gather(table: torch.Tensor, ids: torch.Tensor):
    """Check and stage one gather on the card without launching it.
    Returns ``(launch, out)``: ``launch()`` enqueues the kernel on
    PyTorch's current stream and does no other host work; ``out`` is the
    (M, F) float32 result."""
    if table.dim() != 2:
        raise ValueError(f"table of shape {tuple(table.shape)}, expected "
                         "(N, F)")
    launch, out, _ = _plan_gather("onehot_gather_call", [table], None, ids)
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


def plan_by_sid_snapshot(values: Sequence[torch.Tensor],
                         timestamps: Sequence[torch.Tensor],
                         ids: torch.Tensor):
    """Check and stage one by-sid snapshot on the card without launching
    it.  Returns ``(launch, (values_by_sid, ts_by_sid))``."""
    if len(values) != len(timestamps):
        raise ValueError(f"{len(values)} value planes and "
                         f"{len(timestamps)} timestamp planes")
    if values and values[0].dtype != torch.float32:
        raise ValueError(f"value planes of {values[0].dtype}, expected "
                         "float32")
    launch, out, out_ts = _plan_gather("by_sid_snapshot_call", list(values),
                                       list(timestamps), ids)
    return launch, (out, out_ts)


def by_sid_snapshot_call(values: Sequence[torch.Tensor],
                         timestamps: Sequence[torch.Tensor],
                         ids: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the by-sid snapshot on PyTorch's current stream: the S <= 64
    shards' ``values`` (L, C) float32 and ``timestamps`` (L,) int32 planes,
    read in place, and ``ids`` (M,) into their flat (S L) row space, on
    one CUDA device -> ``(values_by_sid (M, C) float32, ts_by_sid (M,)
    int32)``, zeros for ids outside [0, S L) — bit-identical to
    ``ref.by_sid_snapshot_ref``.  Counts one launch in
    ``by_sid_snapshot_call.launches``."""
    launch, out = plan_by_sid_snapshot(values, timestamps, ids)
    launch()
    by_sid_snapshot_call.launches += 1
    return out


by_sid_snapshot_call.launches = 0


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
