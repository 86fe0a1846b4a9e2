"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory), the
port of ``repro.models.xlstm``.

mLSTM has no hidden-to-hidden dependence, so a whole prompt runs in the
chunkwise-parallel form through ``kernels.mlstm_chunk``: the CUDA kernel
for tensors on the card (from the zero state, as prefill starts), its
plain chunkwise version on the CPU or with ``use_kernel=False``.  A
decode token continues a cache through :func:`mlstm_step`, plain torch on
every device as in ``repro``.  sLSTM's recurrent weights make it
sequential: a Python loop over time in plain torch (``repro`` has no
kernel for it either) that only enqueues device work.

Stabilized recurrences (Beck et al. 2024):
    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = e^{log f + m_{t-1} - m_t} C_{t-1} + e^{log i - m_t} v k^T
    n_t likewise;  h_t = (C_t q_t) / max(|n_t . q_t|, e^{-m_t})

Every float32 cast of ``repro`` is a cast to the wider of float32 and the
input's type, so float32 and bf16 inputs compute as in ``repro`` and a
float64 model runs in float64 throughout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
from repro_torch.kernels.mlstm_chunk.ref import NEG, init_mlstm_state  # noqa: F401
from repro_torch.models import layers

def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _headwise_norm(x: torch.Tensor, gamma: torch.Tensor, n_heads: int,
                   eps: float) -> torch.Tensor:
    """RMS-normalize each head separately (the blocks' GroupNorm)."""
    B, L, D = x.shape
    wd = _wide(x.dtype)
    xh = x.reshape(B, L, n_heads, D // n_heads).to(wd)
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + eps)
    return (xh.reshape(B, L, D) * gamma.to(wd)).to(x.dtype)


# --------------------------------------------------------------------------
# mLSTM cell — one decode step
# --------------------------------------------------------------------------

def mlstm_step(q, k, v, i_raw, f_raw, state):
    """Single-token decode.  q/k/v: (B, H, Dh); gates (B, H); state
    (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H)).  Returns h (B, H, Dh) and
    the new state, in the wider of float32 and q's type."""
    C0, n0, m0 = state
    Dh = q.shape[-1]
    wd = _wide(q.dtype)
    q = q.to(wd) * (Dh ** -0.5)
    k, v = k.to(wd), v.to(wd)
    lf = F.logsigmoid(f_raw.to(wd))
    m1 = torch.maximum(lf + m0, i_raw)
    ip = torch.exp(i_raw - m1)
    fp = torch.exp(lf + m0 - m1)
    C1 = fp[..., None, None] * C0 + ip[..., None, None] * torch.einsum(
        "bhv,bhk->bhvk", v, k)
    n1 = fp[..., None] * n0 + ip[..., None] * k
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n1)),
                        torch.exp(-m1))
    h = torch.einsum("bhk,bhvk->bhv", q, C1) / den[..., None]
    return h, (C1, n1, m1)


# --------------------------------------------------------------------------
# mLSTM block
# --------------------------------------------------------------------------

def mlstm_block(cfg, p: Dict, x: torch.Tensor, cache: Optional[Dict] = None,
                collect: bool = False, use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """xLSTM mLSTM block (projection factor 2, conv4, gated output);
    residual added by the caller.  With a cache holding (conv, C, n, m) it
    decodes one token through :func:`mlstm_step` from that state in
    float32; otherwise the whole prompt runs from the zero state through
    ``mlstm_chunkwise`` (``use_kernel`` goes there).  ``collect=True`` (or
    a cache) returns the final (conv, C, n, m) as the new cache."""
    B, L, D = x.shape
    Di = int(cfg.mlstm_proj_factor * D)
    H = cfg.n_heads
    Dh = Di // H
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    xm, z = torch.chunk(h @ p["w_up"], 2, dim=-1)       # (B, L, Di) each

    conv_state = cache["conv"] if cache else None
    xc, conv_state = layers.causal_conv1d(xm, p["conv"], conv_state)
    xc = F.silu(xc)

    def proj(t, w):
        # block-diagonal per-head projection: (B,L,H,Dh) x (H,Dh,Dh)
        return torch.einsum("blhd,hde->bhle", t.reshape(B, L, H, Dh), w)

    q, k = proj(xc, p["wq"]), proj(xc, p["wk"])
    v = proj(xm, p["wv"])
    gif = xm @ p["w_if"] + p["b_if"]                    # (B, L, 2H)
    wd = _wide(gif.dtype)
    i_raw = gif[..., :H].transpose(1, 2).to(wd)
    f_raw = gif[..., H:].transpose(1, 2).to(wd)
    if cache is not None and "C" in cache:
        cw = _wide(cache["C"].dtype)
        state = (cache["C"].to(cw), cache["n"].to(cw), cache["m"].to(cw))
        hh, (C1, n1, m1) = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                      i_raw[:, :, 0], f_raw[:, :, 0], state)
        hh = hh[:, :, None, :]
    else:
        hh, (C1, n1, m1) = mlstm_chunkwise(q, k, v, i_raw, f_raw,
                                           chunk=cfg.mlstm_chunk,
                                           use_kernel=use_kernel)

    hh = hh.transpose(1, 2).reshape(B, L, Di).to(x.dtype)
    hh = _headwise_norm(hh, p["head_norm"], H, cfg.norm_eps)
    y = (hh * F.silu(z)) @ p["w_down"]

    new_cache = None
    if cache is not None or collect:
        new_cache = {"conv": conv_state, "C": C1.to(cfg.cdtype),
                     "n": n1.to(cfg.cdtype), "m": m1}
    return y, new_cache


# --------------------------------------------------------------------------
# sLSTM — sequential scan with block-diagonal recurrence
# --------------------------------------------------------------------------

def slstm_scan(gates_x: torch.Tensor, r: torch.Tensor, state, n_heads: int):
    """gates_x: (B, L, 4D) input contributions (order i, f, z, o); r:
    (4, H, Dh, Dh) recurrent weights; state: (h, c, n, m) each (B, D).
    Returns hs (B, L, D) and the final state, in the wider of float32
    and gates_x's type.

    The loop keeps the state as (H, B, Dh) and the gates as (L, H, B, 4,
    Dh), so a step is one batched product with the (H, Dh, 4 Dh)
    recurrent matrix and elementwise work, with no copy of the state.
    The gates are unbound once and the steps' outputs stacked at the end,
    so a backward runs one stack and one unbind, not a zero tensor of
    all L steps per step."""
    B, L, D4 = gates_x.shape
    D = D4 // 4
    H = n_heads
    Dh = D // H
    wd = _wide(gates_x.dtype)
    gx = gates_x.to(wd).reshape(B, L, 4, H, Dh).permute(1, 3, 0, 2, 4) \
        .contiguous()                                   # (L, H, B, 4, Dh)
    r2 = r.to(wd).permute(1, 2, 0, 3).reshape(H, Dh, 4 * Dh)

    def heads(s):                                       # (B, D) -> (H, B, Dh)
        return s.to(wd).reshape(B, H, Dh).transpose(0, 1).contiguous()

    h, c, n, m = (heads(s) for s in state)
    hs = []
    for gx_t in gx.unbind(0):
        rec = torch.bmm(h, r2).view(H, B, 4, Dh)
        gi, gf, gz, go = (gx_t + rec).unbind(2)
        fm = gf + m
        m1 = torch.maximum(fm, gi)
        ip = torch.exp(gi - m1)
        fp = torch.exp(fm - m1)
        c = fp * c + ip * torch.tanh(gz)
        n = fp * n + ip
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        hs.append(h)
        m = m1
    hs = torch.stack(hs)

    def flat(s):                                        # (H, B, Dh) -> (B, D)
        return s.transpose(0, 1).reshape(B, D)

    return (hs.permute(2, 0, 1, 3).reshape(B, L, D),
            tuple(flat(s) for s in (h, c, n, m)))


def init_slstm_state(B: int, D: int, dtype=torch.float32, device=None):
    z = torch.zeros((B, D), dtype=dtype, device=device)
    return (z, z, z, torch.full((B, D), NEG, dtype=dtype, device=device))


def slstm_block(cfg, p: Dict, x: torch.Tensor, cache: Optional[Dict] = None,
                collect: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """xLSTM sLSTM block: conv4 feeds the i/f gates, post-norm gated FFN;
    residual added by the caller.  ``cache`` (conv, h, c, n, m) continues
    a sequence; ``collect=True`` returns the final state as a cache."""
    B, L, D = x.shape
    H = cfg.n_heads
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    conv_state = cache["conv"] if cache else None
    xc, conv_state = layers.causal_conv1d(h, p["conv"], conv_state)
    xc = F.silu(xc)

    g_if = xc @ p["w_if"]                               # (B, L, 2D)
    g_zo = h @ p["w_zo"]                                # (B, L, 2D)
    gates_x = torch.cat([g_if, g_zo], dim=-1) + p["b_gates"]

    if cache is not None and "h" in cache:
        state = tuple(cache[k] for k in ("h", "c", "n", "m"))
    else:
        state = init_slstm_state(B, D, _wide(gates_x.dtype), x.device)
    hs, state = slstm_scan(gates_x, p["r_gates"], state, H)

    hs = _headwise_norm(hs.to(x.dtype), p["head_norm"], H, cfg.norm_eps)
    y = hs @ p["w_out"]
    # gated FFN (projection factor 4/3)
    y2 = layers.rms_norm(x + y, p["ffn_norm"], cfg.norm_eps)
    y = y + layers.swiglu(y2, p["w_gate"], p["w_up"], p["w_down"])

    new_cache = None
    if cache is not None or collect:
        hh, c, n, m = state
        new_cache = {"conv": conv_state, "h": hh, "c": c, "n": n, "m": m}
    return y, new_cache
