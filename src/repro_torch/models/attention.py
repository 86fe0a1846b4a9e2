"""GQA attention: global / sliding-window prefill, the KV caches it
leaves and one-token decode against them (the port of
``repro.models.attention``).

Conventions: q (B, L, H, Dh), k/v (B, S, KV, Dh); grouped heads
G = H // KV; softmax statistics in float32.  Sliding-window caches are
ring buffers of ``window`` slots; the slot of absolute position p is
``p % window``.

``attention_block`` attends a prompt through ``kernels.flash_attention``
(the CUDA kernel on the card, its plain version on the CPU) and one
decode token through :func:`decode_attend`, plain torch on every device
as in ``repro``, which computes decode attention in jnp outside any
Pallas kernel.  ``attend_causal`` is ``repro``'s q-chunked jnp form with a
soft cap and a query offset, kept as the plain reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
from repro_torch.models import layers

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def qkv_project(x, p, *, n_heads, n_kv, d_head, qk_norm_eps=None):
    """x: (B, L, D) -> q (B,L,H,Dh), k,v (B,L,KV,Dh)."""
    B, L, _ = x.shape
    q = (x @ p["wq"]).reshape(B, L, n_heads, d_head)
    k = (x @ p["wk"]).reshape(B, L, n_kv, d_head)
    v = (x @ p["wv"]).reshape(B, L, n_kv, d_head)
    if "q_norm" in p:
        q = layers.rms_norm(q, p["q_norm"], qk_norm_eps or 1e-6)
        k = layers.rms_norm(k, p["k_norm"], qk_norm_eps or 1e-6)
    return q, k, v


def _attend(q, k, v, mask, *, softcap=None, scale=None):
    """Grouped attention over an explicit mask.

    q: (B, Lq, H, Dh); k/v: (B, S, KV, Dh); mask: broadcastable to
    (B, KV, G, Lq, S) (True = attend).  Scores in float32.  Returns
    (B, Lq, H*Dh) in v's dtype."""
    B, Lq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, Lq, KV, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Lq, H * Dh)


def attend_causal(q, k, v, *, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset: int = 0,
                  chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, q-chunked: queries
    in chunks of ``chunk`` when Lq > chunk and chunk divides Lq, so the
    live score tensor is (B, KV, G, chunk, S).  ``q_offset`` is the
    absolute position of q[0]."""
    B, Lq, H, Dh = q.shape
    kpos = torch.arange(k.shape[1], device=q.device)

    def block(qc, qpos0, lq):
        qpos = qpos0 + torch.arange(lq, device=q.device) + q_offset
        m = kpos[None, :] <= qpos[:, None]
        if window is not None:
            m &= kpos[None, :] > qpos[:, None] - window
        return _attend(qc, k, v, m[None, None, None], softcap=softcap)

    if Lq <= chunk or Lq % chunk != 0:
        return block(q, 0, Lq)
    return torch.cat([block(q[:, i:i + chunk], i, chunk)
                      for i in range(0, Lq, chunk)], dim=1)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S, KV, Dh)  S = max_len (global) or window (local)
    v: torch.Tensor


def init_kv_cache(B, S, n_kv, d_head, dtype, *, window: Optional[int] = None,
                  device="cuda") -> KVCache:
    """Zero cache of ``S`` slots (``min(S, window)`` for a sliding-window
    layer) on ``device``: the card unless the caller asks for the CPU;
    raises without CUDA."""
    device = resolve_device(device)
    slots = min(S, window) if window else S
    shape = (B, slots, n_kv, d_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cache_from_prefill(k, v, *, window: Optional[int] = None,
                       pad_to: Optional[int] = None) -> KVCache:
    """Build a decode cache from full prefill k/v (post-RoPE).

    ``pad_to``: target capacity for decode continuation (a global cache
    sized exactly L would evict token 0 at the first decode step).  A
    sliding-window cache keeps the last ``window`` positions, rolled so
    that position p sits in slot ``p % window``."""
    L = k.shape[1]
    target = max(L, pad_to) if pad_to is not None else L
    slots = min(window, target) if window is not None else target
    if L >= slots:
        kw = torch.roll(k[:, -slots:], shifts=L % slots, dims=1)
        vw = torch.roll(v[:, -slots:], shifts=L % slots, dims=1)
        return KVCache(kw, vw)
    pad = (0, 0, 0, 0, 0, slots - L)
    return KVCache(torch.nn.functional.pad(k, pad),
                   torch.nn.functional.pad(v, pad))


def decode_attend(q, cache: KVCache, k_new, v_new, pos, *,
                  softcap: Optional[float] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: insert (k_new, v_new) at ``pos`` and attend.

    q: (B, 1, H, Dh); k_new/v_new: (B, 1, KV, Dh); pos: (B,) integer
    absolute position of the new token.  Row b writes slot ``pos[b] % S``
    (the identity for a full-length cache, the ring's wrap for a
    sliding-window one), indexed by ``arange(B)`` and that slot, so no
    index leaves the cache.  The first ``min(pos + 1, S)`` slots are
    attended.  Returns ((B, 1, H*Dh), the new cache); the given cache is
    not written."""
    B = q.shape[0]
    S = cache.k.shape[1]
    pos = pos.to(device=q.device, dtype=torch.long)
    slot = torch.remainder(pos, S)
    rows = torch.arange(B, device=q.device)
    k = cache.k.index_put((rows, slot), k_new[:, 0].to(cache.k.dtype))
    v = cache.v.index_put((rows, slot), v_new[:, 0].to(cache.v.dtype))
    n_valid = torch.clamp(pos + 1, max=S)                # (B,)
    mask = torch.arange(S, device=q.device)[None, :] < n_valid[:, None]
    out = _attend(q, k, v, mask[:, None, None, None, :], softcap=softcap)
    return out, KVCache(k, v)


# --------------------------------------------------------------------------
# Block wrapper used by model.py
# --------------------------------------------------------------------------

def attention_block(cfg, p, x, positions, *, local: bool, cache=None,
                    decode_pos=None, cache_pad_to: Optional[int] = None,
                    use_kernel: Optional[bool] = None):
    """Pre-norm attention sub-block (residual added by the caller).

    ``cache``: a :class:`KVCache` to decode one token against at
    ``decode_pos`` (B,), returning the updated cache; "collect" to attend
    the whole prompt and return its prefill-built cache (padded to
    ``cache_pad_to`` slots); None for the prompt alone.  ``use_kernel``
    goes to ``flash_attention_blhd`` (the prompt path)."""
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps, plus_one=cfg.gemma_norm)
    q, k, v = qkv_project(h, p, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                          d_head=cfg.d_head,
                          qk_norm_eps=cfg.norm_eps if cfg.qk_norm else None)
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    if cfg.pos_emb == "rope":
        if cfg.mrope:
            q = layers.apply_mrope(q, positions, theta, cfg.mrope_sections)
            k = layers.apply_mrope(k, positions, theta, cfg.mrope_sections)
        else:
            pos2d = positions if positions.dim() == 2 else positions[None, :]
            q = layers.apply_rope(q, pos2d, theta)
            k = layers.apply_rope(k, pos2d, theta)
    window = cfg.window if local else None
    new_cache = None
    if isinstance(cache, KVCache):
        if decode_pos is None:
            raise ValueError("decoding against a KVCache needs decode_pos")
        out, new_cache = decode_attend(q, cache, k, v, decode_pos,
                                       softcap=cfg.attn_logit_softcap)
    else:
        out = flash_attention_blhd(q, k, v, window=window,
                                   softcap=cfg.attn_logit_softcap,
                                   use_kernel=use_kernel)
        if cache == "collect":
            new_cache = cache_from_prefill(k, v, window=window,
                                           pad_to=cache_pad_to)
    return out @ p["wo"], new_cache
