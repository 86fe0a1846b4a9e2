"""Mamba (S6) selective-state-space mixer on the prefill path (the port of
``repro.models.ssm``; the custom-VJP training scan comes with the
training slice).

``mamba_block`` builds the discretised a = exp(dt * A) and bx = dt * x * B
as (B, L, Di, S) float32 tensors, as ``repro`` does, and solves the
recurrence through ``ssm_scan`` -> ``kernels.selective_scan``: the CUDA
kernel on the card, its sequential plain version on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models import layers


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor, *, use_kernel: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence with the output contraction.  a, bx:
    (B, L, Di, S); c: (B, L, S); h0: (B, Di, S).  Returns y (B, L, Di)
    float32 and the final state (B, Di, S).  ``repro`` solves it in
    chunks of ``cfg.ssm_chunk`` by an associative scan; both the kernel
    and its plain version here run it as one sequential pass, so the
    chunk has no part in the port."""
    return selective_scan(a, bx, c, h0, use_kernel=use_kernel)


def _proj_dtbc(cfg, p, xc):
    """x_conv (B, L, Di) -> dt (B,L,Di) f32, Bc/Cc (B,L,S) f32."""
    R, S = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]                             # (B, L, R + 2S)
    dt_r, bc, cc = torch.split(proj, [R, S, S], dim=-1)
    if cfg.ssm_norm:
        dt_r = layers.rms_norm(dt_r, p["dt_norm"], cfg.norm_eps)
        bc = layers.rms_norm(bc, p["b_norm"], cfg.norm_eps)
        cc = layers.rms_norm(cc, p["c_norm"], cfg.norm_eps)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"].float())
    return dt, bc.float(), cc.float()


def mamba_block(cfg, p: Dict, x: torch.Tensor, cache: Optional[Dict] = None,
                collect: bool = False, use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm Mamba sub-block (residual added by the caller).

    cache: {"conv": (B, K-1, Di), "ssm": (B, Di, S)} to continue from, or
    None.  ``collect=True`` returns the final state as a fresh cache
    (prefill).  ``use_kernel`` goes to the selective scan."""
    B, L, D = x.shape
    Di, S = cfg.d_inner, cfg.ssm_state
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps, plus_one=cfg.gemma_norm)
    xz = h @ p["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)                 # (B, L, Di) each

    conv_state = cache["conv"] if cache else None
    xc, conv_state = layers.causal_conv1d(xin, p["conv"], conv_state)
    xc = F.silu(xc)

    dt, bc, cc = _proj_dtbc(cfg, p, xc)
    A = -torch.exp(p["A_log"].float())                  # (Di, S)
    xcf = xc.float()
    a_bar = torch.exp(dt[..., None] * A)                # (B, L, Di, S)
    bx = (dt * xcf)[..., None] * bc[:, :, None, :]      # (B, L, Di, S)

    h0 = (cache["ssm"].float() if cache else
          torch.zeros((B, Di, S), dtype=torch.float32, device=x.device))
    y, h_final = ssm_scan(a_bar, bx, cc, h0, use_kernel=use_kernel)
    del a_bar, bx                                       # 2 x B L Di S floats
    y = y + p["D"].float() * xcf
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]

    new_cache = None
    if cache is not None or collect:
        new_cache = {"conv": conv_state, "ssm": h_final.to(cfg.cdtype)}
    return y, new_cache
