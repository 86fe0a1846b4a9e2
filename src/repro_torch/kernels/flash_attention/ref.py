"""Plain torch version of causal / sliding-window GQA attention: the CPU
path and the oracle of :mod:`repro_torch.kernels.flash_attention.kernel`
— the port of the JAX package's ``flash_attention/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Lq, Dh); k/v: (B, KV, S, Dh); kv head = q head // (H/KV).
    Query i attends to keys j <= i (``causal``) and j > i - ``window``.
    Scores, softmax and the weighted sum in float32.  Returns
    (B, H, Lq, Dh) float32."""
    B, H, Lq, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, G, Lq, Dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qpos = torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((Lq, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Lq, Dh)
