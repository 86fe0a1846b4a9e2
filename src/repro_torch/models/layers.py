"""Common neural layers: norms, rotary embeddings (incl. M-RoPE), MLPs
(the port of ``repro.models.layers``).

All functions are pure (parameters passed explicitly) and keep ``repro``'s
dtype discipline: normalization statistics and rotary angles in float32,
matrix products in the inputs' (compute) dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32 (float64 for a float64 ``x``), cast back to
    ``x``'s dtype; ``plus_one`` uses the gemma (1+g) convention."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    g = gamma.to(xf.dtype)
    if plus_one:
        g = 1.0 + g
    return (xn * g).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """(d_head/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x``'s last dim (not interleaved pairs)
    by ``ang`` (..., L, Dh/2), in float32."""
    cos = torch.cos(ang)[..., None, :]                    # (..., L, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., L, H, Dh); positions: broadcastable to (..., L) integer."""
    inv = rope_freqs(x.shape[-1], theta, x.device)        # (Dh/2,)
    return _rotate(x, positions[..., None].float() * inv)  # (..., L, Dh/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, L, H, Dh); positions: (3, B, L)
    temporal / height / width ids.  The Dh/2 frequency slots are split
    into ``sections`` (sum == Dh/2), each taking its angle from its own
    position stream."""
    d_head = x.shape[-1]
    inv = rope_freqs(d_head, theta, x.device)
    ang_all = positions[..., None].float() * inv          # (3, B, L, Dh/2)
    idx = torch.repeat_interleave(torch.arange(3, device=x.device),
                                  torch.tensor(sections, device=x.device))
    ang = torch.gather(torch.movedim(ang_all, 0, -1),     # (B, L, Dh/2, 3)
                       -1, idx[None, None, :, None].expand(
                           *ang_all.shape[1:], 1))[..., 0]
    return _rotate(x, ang)


def sinusoidal_positions(L: int, d_model: int, offset=0,
                         device=None) -> torch.Tensor:
    """(L, d_model) fixed sinusoidal table (musicgen)."""
    pos = (torch.arange(L, dtype=torch.float32, device=device)
           + offset)[:, None]
    half = d_model // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: the tanh form, not torch's
    default erf form."""
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    a = F.silu(g) if act == "silu" else _gelu(g)
    return (a * u) @ w_down


def mlp_plain(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              act: str = "gelu") -> torch.Tensor:
    h = x @ w_up
    if act == "gelu":
        h = _gelu(h)
    elif act == "relu2":                  # nemotron squared ReLU
        h = torch.square(F.relu(h))
    else:
        h = F.relu(h)
    return h @ w_down


# --------------------------------------------------------------------------
# Causal depthwise conv (mamba block)
# --------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution along time, summed in float32
    (float64 for a float64 ``x``).

    x: (B, L, D); kernel: (K, D).  ``state``: (B, K-1, D) carried context
    (decode) or None (zero left-pad).  Returns (y, new_state)."""
    B, L, D = x.shape
    K = kernel.shape[0]
    wd = torch.promote_types(x.dtype, torch.float32)
    if state is None:
        state = torch.zeros((B, K - 1, D), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                     # (B, L+K-1, D)
    y = torch.zeros((B, L, D), dtype=wd, device=x.device)
    for k in range(K):                                    # K is tiny (4)
        y = y + xp[:, k:k + L, :].to(wd) * kernel[k].to(wd)
    new_state = (xp[:, -(K - 1):, :] if K > 1
                 else torch.zeros((B, 0, D), dtype=x.dtype, device=x.device))
    return y.to(x.dtype), new_state
