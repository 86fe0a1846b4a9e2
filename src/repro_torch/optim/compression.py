"""Int8 gradient compression with error feedback (the port of
``repro.optim.compression``'s pytree transform).

Each gradient leaf, plus the residual carried from the last step, is
quantized to int8 with a per-tensor scale and dequantized again; the new
residual is what the quantization lost, so the scheme stays unbiased over
time.  ``repro``'s ``compressed_psum``, the int8 all-reduce of the wire
format, waits for the port's ``torch.distributed`` backend.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.models.params import tree_map


class CompressionState(NamedTuple):
    error: dict          # residual tree, same structure as the gradients


def compress_init(params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and their scale, max |x| / 127 + 1e-12 (round half to
    even, clipped to +-127)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compressed_gradients(grads, state: CompressionState
                         ) -> Tuple[dict, CompressionState]:
    """Quantize each gradient leaf to int8 (with error feedback); returns
    the dequantized gradients and the new residual state."""
    def one(g, e):
        gf = g.float() + e
        q, scale = _quantize(gf)
        deq = q.float() * scale
        return deq, gf - deq

    out = tree_map(one, grads, state.error)
    return (tree_map(lambda t: t[0], out),
            CompressionState(tree_map(lambda t: t[1], out)))
