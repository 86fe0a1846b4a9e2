"""Fine-grained Mixture-of-Experts: shared + routed experts, top-k routing
(the port of ``repro.models.moe``).

Dense GShard-style capacity dispatch: tokens are grouped, each group
builds a (S, E, C) dispatch/combine tensor, and the expert FFNs run as
batched products over the expert dimension.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def topk_route(logits: torch.Tensor, k: int, renorm: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (..., E) -> gates (..., k) f32, idx (..., k) int, probs f32.
    Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable descending sort keeps equal probabilities in index order."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    if renorm:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def dispatch_combine(idx: torch.Tensor, gates: torch.Tensor, n_experts: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-limited dispatch/combine tensors.

    idx/gates: (G, S, K).  Rank-major priority (all rank-0 choices win
    positions before rank-1), position within an expert by token order.
    Returns dispatch, combine: (G, S, E, C) float32; dispatch is one-hot,
    combine carries the gate values.  Tokens over capacity are dropped."""
    G, S, K = idx.shape
    E, C = n_experts, capacity
    dev = idx.device
    base = torch.zeros((G, 1, E), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((G, S, E, C), dtype=torch.float32, device=dev)
    combine = torch.zeros((G, S, E, C), dtype=torch.float32, device=dev)
    for j in range(K):
        oh = F.one_hot(idx[:, :, j].long(), E).float()                # (G,S,E)
        cum = torch.cumsum(oh, dim=1) - oh                            # exclusive
        pos = torch.sum(oh * (cum + base), dim=-1)                    # (G,S)
        keep = pos < C
        # a position past the capacity has no one-hot row (jax.nn.one_hot
        # gives zeros there); ``keep`` drops the clamped stand-in
        poh = F.one_hot(torch.clamp(pos.long(), max=C - 1), C).float()
        cell = oh[..., None] * poh[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + cell
        combine = combine + cell * gates[:, :, j, None, None]
        base = base + torch.sum(oh, dim=1, keepdim=True)
    return dispatch, combine


def load_balance_loss(idx: torch.Tensor, probs: torch.Tensor, n_experts: int
                      ) -> torch.Tensor:
    """GShard/Switch auxiliary loss: E * sum_e f_e * P_e."""
    oh = F.one_hot(idx.long(), n_experts).float()             # (..., K, E)
    f = oh.reshape(-1, n_experts).mean(0)                     # (E,)
    p = probs.reshape(-1, n_experts).mean(0)
    return n_experts * torch.sum(f * p)


def moe_block(cfg, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-normed MoE FFN sub-block. x: (B, L, D) -> (y, aux_loss)."""
    B, L, D = x.shape
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps, plus_one=cfg.gemma_norm)
    cd = cfg.cdtype

    S = cfg.moe_group or min(512, L)
    S = min(S, L)
    assert L % S == 0, (L, S)
    G = B * (L // S)
    hg = h.reshape(G, S, D)

    logits = hg.float() @ p["router"].float()
    gates, idx, probs = topk_route(logits, cfg.top_k, cfg.renorm_topk)
    aux = load_balance_loss(idx, probs, cfg.n_experts)

    # Python's round() halves to even, as repro's capacity does
    cap = int(max(1, round(S * cfg.top_k * cfg.capacity_factor / cfg.n_experts)))
    cap = min(cap, S)
    disp, comb = dispatch_combine(idx, gates, cfg.n_experts, cap)

    # expert FFNs (E, G*C rows)
    e_in = torch.einsum("gsec,gsd->egcd", disp.to(cd), hg.to(cd))
    g = torch.einsum("egcd,edf->egcf", e_in, p["w_gate"])
    u = torch.einsum("egcd,edf->egcf", e_in, p["w_up"])
    e_out = torch.einsum("egcf,efd->egcd", F.silu(g) * u, p["w_down"])
    y = torch.einsum("gsec,egcd->gsd", comb.to(cd), e_out).reshape(B, L, D)

    if cfg.n_shared > 0:
        sh = layers.swiglu(h, p["ws_gate"], p["ws_up"], p["ws_down"])
        if cfg.shared_gate:
            sg = torch.sigmoid((h @ p["w_shared_gate"]).float())
            sh = sh * sg.to(sh.dtype)
        y = y + sh
    return y.to(x.dtype), aux
