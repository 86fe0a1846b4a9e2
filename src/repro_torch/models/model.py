"""Block-pattern language model (the port of ``repro.models.model``:
parameter and cache tables, ``forward``, the loss and the train step,
``make_prefill_step``, the one-token ``make_decode_step`` and the
modality stub ``input_specs``).

A model is ``ModelConfig.prefix + pattern * n_scan`` (mixer, mlp) layers.
The parameter tree is ``repro``'s: unscanned ``prefix/l{i}`` layers and
the repeated pattern's ``scan/s{j}`` layers stacked along a leading
``n_scan`` dim.  ``repro`` runs the pattern with ``lax.scan``; here it is
a Python loop over the stacked leaves, with the caches stacked the same
way.  Attention layers attend through ``kernels.flash_attention`` and
Mamba layers scan through ``kernels.selective_scan`` and mLSTM layers
through ``kernels.mlstm_chunk``: the CUDA kernels for tensors on the
card, their plain versions on the CPU or with ``use_kernel=False``.
sLSTM layers run a plain torch loop over time on every device.

A decode step passes every layer its cache: attention decodes against
its KV ring and mLSTM steps its (C, n, m) in plain torch, as ``repro``
does; a Mamba layer continues its (conv, ssm) state through the
selective-scan kernel at L = 1, the one kernel on the decode path.

Training differentiates the same forward with autograd: each kernel's
wrapper goes through an ``autograd.Function`` whose forward is the kernel
and whose backward is the plain version's gradient (the scan's: ``repro``'s
adjoint recurrence), since ``repro`` has no backward kernel either.
``remat`` recomputes each scan slot's layers in the backward
(``torch.utils.checkpoint``), as ``repro``'s ``jax.checkpoint`` of the
scan body does, so the kernels launch again there.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import optim
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention, layers, moe, ssm, xlstm
from repro_torch.models.config import (ATTN, ATTN_LOCAL, DENSE, MAMBA, MLSTM,
                                       MOE, SLSTM, ModelConfig, ShapeConfig)
from repro_torch.models.params import (ParamSpec, Path, count, tree_leaves,
                                       tree_map, tree_paths, unflatten)


# --------------------------------------------------------------------------
# Parameter spec tables
# --------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pd = cfg.param_dtype
    s = {
        "norm": ParamSpec((D,), ("d_model",), "zeros" if cfg.gemma_norm else "ones", pd),
        "wq": ParamSpec((D, H * dh), ("d_model", "heads_dh"), "normal", pd),
        "wk": ParamSpec((D, KV * dh), ("d_model", "kv_dh"), "normal", pd),
        "wv": ParamSpec((D, KV * dh), ("d_model", "kv_dh"), "normal", pd),
        "wo": ParamSpec((H * dh, D), ("heads_dh", "d_model"), "normal", pd),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), (None,), "ones", pd)
        s["k_norm"] = ParamSpec((dh,), (None,), "ones", pd)
    return s


def _mlp_specs(cfg: ModelConfig, width: int) -> Dict[str, ParamSpec]:
    D, pd = cfg.d_model, cfg.param_dtype
    s = {"norm": ParamSpec((D,), ("d_model",),
                           "zeros" if cfg.gemma_norm else "ones", pd),
         "w_up": ParamSpec((D, width), ("d_model", "d_ff"), "normal", pd),
         "w_down": ParamSpec((width, D), ("d_ff", "d_model"), "normal", pd)}
    if cfg.mlp_gated:
        s["w_gate"] = ParamSpec((D, width), ("d_model", "d_ff"), "normal", pd)
    return s


def _moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, E, Fe, pd = cfg.d_model, cfg.n_experts, cfg.d_expert, cfg.param_dtype
    s = {
        "norm": ParamSpec((D,), ("d_model",), "ones", pd),
        "router": ParamSpec((D, E), ("d_model", None), "normal", "float32"),
        "w_gate": ParamSpec((E, D, Fe), ("experts", "d_model", "d_expert"), "normal", pd),
        "w_up": ParamSpec((E, D, Fe), ("experts", "d_model", "d_expert"), "normal", pd),
        "w_down": ParamSpec((E, Fe, D), ("experts", "d_expert", "d_model"), "normal", pd),
    }
    if cfg.n_shared > 0:
        Fs = cfg.n_shared * Fe
        s["ws_gate"] = ParamSpec((D, Fs), ("d_model", "d_ff"), "normal", pd)
        s["ws_up"] = ParamSpec((D, Fs), ("d_model", "d_ff"), "normal", pd)
        s["ws_down"] = ParamSpec((Fs, D), ("d_ff", "d_model"), "normal", pd)
        if cfg.shared_gate:
            s["w_shared_gate"] = ParamSpec((D, 1), ("d_model", None), "normal", pd)
    return s


def _mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, Di, S, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    pd = cfg.param_dtype
    s = {
        "norm": ParamSpec((D,), ("d_model",), "ones", pd),
        "in_proj": ParamSpec((D, 2 * Di), ("d_model", "d_inner2"), "normal", pd),
        "conv": ParamSpec((K, Di), (None, "d_inner"), "normal", pd, scale=0.5),
        "x_proj": ParamSpec((Di, R + 2 * S), ("d_inner", None), "normal", pd),
        "dt_proj": ParamSpec((R, Di), (None, "d_inner"), "normal", pd),
        "dt_bias": ParamSpec((Di,), ("d_inner",), "dt_bias", "float32"),
        "A_log": ParamSpec((Di, S), ("d_inner", None), "a_log", "float32"),
        "D": ParamSpec((Di,), ("d_inner",), "ones", "float32"),
        "out_proj": ParamSpec((Di, D), ("d_inner", "d_model"), "normal", pd),
    }
    if cfg.ssm_norm:
        s["dt_norm"] = ParamSpec((R,), (None,), "ones", pd)
        s["b_norm"] = ParamSpec((S,), (None,), "ones", pd)
        s["c_norm"] = ParamSpec((S,), (None,), "ones", pd)
    return s


def _mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, Dm, H, K = cfg.d_model, cfg.d_mlstm, cfg.n_heads, cfg.conv_kernel
    dh = Dm // H
    pd = cfg.param_dtype
    # q/k/v are block-diagonal per head (the official mLSTM parameterization)
    return {
        "norm": ParamSpec((D,), ("d_model",), "ones", pd),
        "w_up": ParamSpec((D, 2 * Dm), ("d_model", "d_inner2"), "normal", pd),
        "conv": ParamSpec((K, Dm), (None, "d_inner"), "normal", pd, scale=0.5),
        "wq": ParamSpec((H, dh, dh), ("heads", None, "mlstm_dh"), "normal", pd),
        "wk": ParamSpec((H, dh, dh), ("heads", None, "mlstm_dh"), "normal", pd),
        "wv": ParamSpec((H, dh, dh), ("heads", None, "mlstm_dh"), "normal", pd),
        "w_if": ParamSpec((Dm, 2 * H), ("d_inner", None), "small", "float32"),
        "b_if": ParamSpec((2 * H,), (None,), "zeros", "float32"),
        "head_norm": ParamSpec((Dm,), ("d_inner",), "ones", pd),
        "w_down": ParamSpec((Dm, D), ("d_inner", "d_model"), "normal", pd),
    }


def _slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, H, K = cfg.d_model, cfg.n_heads, cfg.conv_kernel
    dh = D // H
    Fs = cfg.slstm_ff or int(4 * D / 3)
    pd = cfg.param_dtype
    return {
        "norm": ParamSpec((D,), ("d_model",), "ones", pd),
        "conv": ParamSpec((K, D), (None, "d_model"), "normal", pd, scale=0.5),
        "w_if": ParamSpec((D, 2 * D), ("d_model", None), "normal", pd),
        "w_zo": ParamSpec((D, 2 * D), ("d_model", None), "normal", pd),
        "b_gates": ParamSpec((4 * D,), (None,), "zeros", "float32"),
        "r_gates": ParamSpec((4, H, dh, dh), (None, None, None, None), "normal", pd),
        "head_norm": ParamSpec((D,), ("d_model",), "ones", pd),
        "w_out": ParamSpec((D, D), ("d_model", None), "normal", pd),
        "ffn_norm": ParamSpec((D,), ("d_model",), "ones", pd),
        "w_gate": ParamSpec((D, Fs), ("d_model", "d_ff"), "normal", pd),
        "w_up": ParamSpec((D, Fs), ("d_model", "d_ff"), "normal", pd),
        "w_down": ParamSpec((Fs, D), ("d_ff", "d_model"), "normal", pd),
    }


_MIXER_SPECS = {ATTN: _attn_specs, ATTN_LOCAL: _attn_specs,
                MAMBA: _mamba_specs, MLSTM: _mlstm_specs, SLSTM: _slstm_specs}


def _layer_specs(cfg: ModelConfig, spec) -> Dict[str, Dict[str, ParamSpec]]:
    mixer, mlp = spec
    out = {"mixer": _MIXER_SPECS[mixer](cfg)}
    if mlp == DENSE:
        width = cfg.d_ff_prefix if (cfg.d_ff_prefix and spec in cfg.prefix) else cfg.d_ff
        out["mlp"] = _mlp_specs(cfg, width)
    elif mlp == MOE:
        out["mlp"] = _moe_specs(cfg)
    return out


def param_specs(cfg: ModelConfig) -> Dict[Path, ParamSpec]:
    D, V = cfg.d_model, cfg.vocab
    pd = cfg.param_dtype
    flat: Dict[Path, ParamSpec] = {}
    if not cfg.embed_inputs:
        eshape = (cfg.n_codebooks, V, D) if cfg.n_codebooks > 1 else (V, D)
        eaxes = ("codebooks", "vocab", "d_model") if cfg.n_codebooks > 1 else ("vocab", "d_model")
        flat[("embed", "tok")] = ParamSpec(eshape, eaxes, "small", pd)
    for i, spec in enumerate(cfg.prefix):
        for comp, d in _layer_specs(cfg, spec).items():
            for name, ps in d.items():
                flat[("prefix", f"l{i}", comp, name)] = ps
    n = cfg.n_scan
    for j, spec in enumerate(cfg.pattern):
        for comp, d in _layer_specs(cfg, spec).items():
            for name, ps in d.items():
                flat[("scan", f"s{j}", comp, name)] = ParamSpec(
                    (n,) + ps.shape, ("layers",) + ps.axes, ps.init, ps.dtype, ps.scale)
    flat[("final", "norm")] = ParamSpec(
        (D,), ("d_model",), "zeros" if cfg.gemma_norm else "ones", pd)
    if not cfg.tie_embeddings:
        hshape = (cfg.n_codebooks, D, V) if cfg.n_codebooks > 1 else (D, V)
        haxes = ("codebooks", "d_model", "vocab") if cfg.n_codebooks > 1 else ("d_model", "vocab")
        flat[("head", "w")] = ParamSpec(hshape, haxes, "normal", pd)
    return flat


def count_params(cfg: ModelConfig, active_only: bool = False,
                 exclude_embed: bool = False) -> int:
    def weight(path: Path, ps: ParamSpec) -> float:
        if exclude_embed and path[0] in ("embed", "head"):
            return 0.0
        if active_only and "experts" in ps.axes:
            return cfg.top_k / cfg.n_experts
        return 1.0
    return count(param_specs(cfg), weight)


# --------------------------------------------------------------------------
# Cache spec tables (decode / prefill-collect)
# --------------------------------------------------------------------------

def _layer_cache_specs(cfg: ModelConfig, spec, B: int, S: int
                       ) -> Dict[str, ParamSpec]:
    mixer, _ = spec
    cd = cfg.compute_dtype
    if mixer in (ATTN, ATTN_LOCAL):
        slots = min(S, cfg.window) if (mixer == ATTN_LOCAL and cfg.window) else S
        sh = (B, slots, cfg.n_kv_heads, cfg.d_head)
        ax = ("batch", "seq", "kv_heads", "d_head")
        return {"k": ParamSpec(sh, ax, "zeros", cd),
                "v": ParamSpec(sh, ax, "zeros", cd)}
    if mixer == MAMBA:
        Di, St, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        return {"conv": ParamSpec((B, K - 1, Di), ("batch", None, "d_inner"), "zeros", cd),
                "ssm": ParamSpec((B, Di, St), ("batch", "d_inner", None), "zeros", cd)}
    if mixer == MLSTM:
        Dm, H, K = cfg.d_mlstm, cfg.n_heads, cfg.conv_kernel
        dh = Dm // H
        return {"conv": ParamSpec((B, K - 1, Dm), ("batch", None, "d_inner"), "zeros", cd),
                "C": ParamSpec((B, H, dh, dh), ("batch", "heads", "mlstm_dh", None), "zeros", cd),
                "n": ParamSpec((B, H, dh), ("batch", "heads", None), "zeros", cd),
                "m": ParamSpec((B, H), ("batch", "heads"), "zeros", "float32")}
    if mixer == SLSTM:
        D, K = cfg.d_model, cfg.conv_kernel
        st = {"conv": ParamSpec((B, K - 1, D), ("batch", None, "d_model"), "zeros", cd)}
        for k in ("h", "c", "n", "m"):
            st[k] = ParamSpec((B, D), ("batch", None), "zeros", "float32")
        return st
    raise ValueError(mixer)


def cache_specs(cfg: ModelConfig, B: int, S: int) -> Dict[Path, ParamSpec]:
    flat: Dict[Path, ParamSpec] = {}
    for i, spec in enumerate(cfg.prefix):
        for name, ps in _layer_cache_specs(cfg, spec, B, S).items():
            flat[("prefix", f"l{i}", name)] = ps
    n = cfg.n_scan
    for j, spec in enumerate(cfg.pattern):
        for name, ps in _layer_cache_specs(cfg, spec, B, S).items():
            flat[("scan", f"s{j}", name)] = ParamSpec(
                (n,) + ps.shape, ("layers",) + ps.axes, ps.init, ps.dtype)
    return flat


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda") -> Dict:
    """Zero caches for B sequences of up to S positions, in
    ``cache_specs``' shapes and dtypes (every leaf zero: a fresh mLSTM
    slot starts from m = 0, as in ``repro``), on ``device``: the card
    unless the caller asks for the CPU; raises without CUDA."""
    device = resolve_device(device)
    return unflatten({p: torch.zeros(s.shape, dtype=_dtype(s.dtype),
                                     device=device)
                      for p, s in cache_specs(cfg, B, S).items()})


def abstract_cache(cfg: ModelConfig, B: int, S: int) -> Dict:
    """``init_cache``'s tree on the meta device: exact shapes and dtypes,
    no storage (``repro``'s ``abstract_cache``)."""
    return init_cache(cfg, B, S, device="meta")


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _apply_layer(cfg, spec, lp, x, positions, collect, cache_pad_to,
                 use_kernel, cache=None, decode_pos=None):
    mixer, mlp = spec
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mixer in (ATTN, ATTN_LOCAL):
        c = None
        if cache is not None:
            c = attention.KVCache(cache["k"], cache["v"])
        elif collect:
            c = "collect"
        y, nc = attention.attention_block(
            cfg, lp["mixer"], x, positions, local=(mixer == ATTN_LOCAL),
            cache=c, decode_pos=decode_pos, cache_pad_to=cache_pad_to,
            use_kernel=use_kernel)
        new_cache = {"k": nc.k, "v": nc.v} if nc is not None else {}
    elif mixer == MAMBA:
        y, nc = ssm.mamba_block(cfg, lp["mixer"], x, cache, collect,
                                use_kernel=use_kernel)
        new_cache = nc if nc is not None else {}
    elif mixer == MLSTM:
        y, nc = xlstm.mlstm_block(cfg, lp["mixer"], x, cache, collect,
                                  use_kernel=use_kernel)
        new_cache = nc if nc is not None else {}
    elif mixer == SLSTM:
        y, nc = xlstm.slstm_block(cfg, lp["mixer"], x, cache, collect)
        new_cache = nc if nc is not None else {}
    else:
        raise ValueError(mixer)
    x = x + y

    if mlp == DENSE:
        p = lp["mlp"]
        h = layers.rms_norm(x, p["norm"], cfg.norm_eps, plus_one=cfg.gemma_norm)
        if cfg.mlp_gated:
            y2 = layers.swiglu(h, p["w_gate"], p["w_up"], p["w_down"], cfg.mlp_act)
        else:
            y2 = layers.mlp_plain(h, p["w_up"], p["w_down"], cfg.mlp_act)
        x = x + y2
    elif mlp == MOE:
        y2, aux = moe.moe_block(cfg, lp["mlp"], x)
        x = x + y2
    return x, new_cache, aux


def _embed(cfg, params, tokens=None, embeds=None, positions=None):
    cd = cfg.cdtype
    if cfg.embed_inputs:
        x = embeds.to(cd)
    elif cfg.n_codebooks > 1:
        # tokens: (B, L, K) — sum the K codebook embeddings
        emb = params["embed"]["tok"]                    # (K, V, D)
        x = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=cd,
                        device=emb.device)
        for k in range(cfg.n_codebooks):
            x = x + emb[k][tokens[:, :, k]].to(cd)
    else:
        x = params["embed"]["tok"][tokens].to(cd)
    if cfg.scale_embed:
        # the constant rounded to the compute dtype first, as repro's
        # jnp.asarray(sqrt(d), cdtype): 33.75, not 33.94, in bf16 at d 1152;
        # a 0-dim host tensor is a scalar to the op, so no copy to the card
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    if cfg.pos_emb == "sinusoidal":
        B, L = x.shape[:2]
        pos = positions if positions.dim() == 2 else positions.expand(B, L)
        half = cfg.d_model // 2
        inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                              device=x.device) / half))
        ang = pos[..., None].float() * inv
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(x.dtype)
    return x


def _head(cfg, params, x):
    x = layers.rms_norm(x, params["final"]["norm"], cfg.norm_eps,
                        plus_one=cfg.gemma_norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].T.to(x.dtype)
    elif cfg.n_codebooks > 1:
        logits = torch.einsum("bld,kdv->blkv", x, params["head"]["w"])
    else:
        logits = x @ params["head"]["w"]
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits.float() / cap)
    return logits


def cast_leaf(cfg: ModelConfig, p: torch.Tensor) -> torch.Tensor:
    """``cast_params``' rule for one leaf: a float32 leaf of two or more
    dims goes to the compute dtype.  A stacked scan leaf counts its layer
    dim, so the stacked norm gammas, ``dt_bias``, ``D`` and ``A_log``
    become the compute dtype too, while the same 1-D leaves of prefix
    layers stay float32 — exactly as in ``repro``."""
    cd = cfg.cdtype
    if cd != torch.float32 and p.dim() >= 2 and p.dtype == torch.float32:
        return p.to(cd)
    return p


def cast_params(cfg: ModelConfig, params):
    """Mixed precision as ``repro``'s ``cast_params``: matrices (and every
    stacked leaf) in the compute dtype, unstacked vectors in float32."""
    return tree_map(lambda p: cast_leaf(cfg, p), params)


def _trunk(cfg: ModelConfig, params, tokens, embeds, positions,
           collect_cache: bool, cache_pad_to: Optional[int],
           use_kernel: Optional[bool], caches=None, decode_pos=None,
           remat: bool = False):
    """Embedding and every layer, on cast parameters: (x before the final
    norm, caches in ``repro``'s tree layout or None, aux loss).  With
    ``caches`` each layer continues from its own cache at the per-row
    positions ``decode_pos`` (B,) and the new caches are returned.
    ``remat`` checkpoints each scan slot's layers (not the prefix's)."""
    ref = tokens if tokens is not None else embeds
    B, L = ref.shape[0], ref.shape[1]
    dev = ref.device
    if positions is None:
        if decode_pos is not None:
            base = decode_pos.to(dev)[:, None]          # (B, 1)
        else:
            base = torch.arange(L, device=dev)[None, :]  # (1, L)
        positions = base.expand(B, L)
        if cfg.mrope:
            positions = positions[None].expand(3, B, L)

    x = _embed(cfg, params, tokens, embeds, positions)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches: Dict = {"scan": {}}
    if cfg.prefix:
        new_caches["prefix"] = {}

    for i, spec in enumerate(cfg.prefix):
        key = f"l{i}"
        c = caches["prefix"][key] if caches is not None else None
        x, nc, a = _apply_layer(cfg, spec, params["prefix"][key], x,
                                positions, collect_cache, cache_pad_to,
                                use_kernel, c, decode_pos)
        new_caches["prefix"][key] = nc
        aux = aux + a

    def slot(x, aux, slot_params, slot_caches):
        outs = {}
        for j, spec in enumerate(cfg.pattern):
            key = f"s{j}"
            c = slot_caches[key] if slot_caches is not None else None
            x, nc, a = _apply_layer(cfg, spec, slot_params[key], x,
                                    positions, collect_cache, cache_pad_to,
                                    use_kernel, c, decode_pos)
            outs[key] = nc
            aux = aux + a
        return x, aux, outs

    # one unbind a stacked leaf: its backward stacks the slots' gradients
    per_slot = tree_map(torch.unbind, params["scan"])
    per_iter = []
    for i in range(cfg.n_scan):
        slot_params = tree_map(lambda leaves: leaves[i], per_slot)
        slot_caches = (tree_map(lambda leaf: leaf[i], caches["scan"])
                       if caches is not None else None)
        if remat:
            x, aux, outs = checkpoint(slot, x, aux, slot_params, slot_caches,
                                      use_reentrant=False)
        else:
            x, aux, outs = slot(x, aux, slot_params, slot_caches)
        per_iter.append(outs)
    new_caches["scan"] = {
        key: {name: torch.stack([it[key][name] for it in per_iter])
              for name in per_iter[0][key]}
        for key in per_iter[0]}
    want_cache = caches is not None or collect_cache
    return x, (new_caches if want_cache else None), aux


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            positions=None, caches=None, decode_pos=None,
            collect_cache: bool = False,
            cache_pad_to: Optional[int] = None,
            remat: bool = False,
            use_kernel: Optional[bool] = None):
    """Full-sequence forward from position 0, or with ``caches`` one
    decode token per row at ``decode_pos`` (B,).  Returns (logits,
    caches_or_None, aux_loss); ``collect_cache`` returns every layer's
    prefill cache in ``repro``'s tree layout.  ``remat`` recomputes each
    scan slot in the backward (training)."""
    params = cast_params(cfg, params)
    x, caches, aux = _trunk(cfg, params, tokens, embeds, positions,
                            collect_cache, cache_pad_to, use_kernel,
                            caches, decode_pos, remat)
    return _head(cfg, params, x), caches, aux


# --------------------------------------------------------------------------
# Loss & step builders
# --------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, logits: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in float32 over the labels >= 0 (musicgen:
    logits (B, L, K, V) against codebook labels (B, L, K)).  ``repro``
    takes the label's logit by an iota compare and sum, for a vocab dim
    that may be sharded; a gather gives the same value without the
    (B, L, V) mask."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    mask = labels >= 0
    n = torch.clamp(mask.sum(), min=1)
    return torch.sum(torch.where(mask, lse - ll, 0.0)) / n


def _split_micro(batch: Dict, accum: int) -> List[Dict]:
    """The batch as ``accum`` micro-batches of contiguous rows (``repro``'s
    reshape to (accum, B / accum, ...))."""
    def sp(x):
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is no multiple of grad_accum "
                             f"{accum}")
        return x.reshape(accum, B // accum, *x.shape[1:])
    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def make_loss_fn(cfg: ModelConfig, use_kernel: Optional[bool] = None):
    """``loss_fn(params, batch)``: the LM loss of ``batch["labels"]`` plus,
    for MoE models, ``router_aux_coef`` times the mean load-balance loss
    over the MoE layers; the forward rematerialises as ``cfg.remat``
    says."""
    n_moe = sum(1 for _, m in cfg.layer_specs if m == MOE)

    def loss_fn(params, batch):
        logits, _, aux = forward(
            cfg, params, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), remat=cfg.remat,
            use_kernel=use_kernel)
        loss = lm_loss(cfg, logits, batch["labels"])
        if n_moe:
            loss = loss + cfg.router_aux_coef * aux / n_moe
        return loss
    return loss_fn


def make_grads_fn(cfg: ModelConfig, use_kernel: Optional[bool] = None):
    """``grads_of(params, batch) -> (loss, grads)``: the loss and its
    gradient with respect to every parameter leaf, over ``cfg.grad_accum``
    micro-batches as ``repro`` does: the losses and the float32 gradients
    summed from zeros in micro-batch order, then times 1 / accum.  A leaf
    that gets no gradient raises: the graph was cut (a kernel launched
    outside its ``autograd.Function``)."""
    loss_fn = make_loss_fn(cfg, use_kernel)
    accum = max(cfg.grad_accum, 1)

    def value_and_grad(params, batch):
        paths = tree_paths(params)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(unflatten(dict(zip(paths, leaves))), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        cut = [path for path, g in zip(paths, grads) if g is None]
        if cut:
            raise RuntimeError(f"no gradient reached {cut}: the graph is "
                               "cut")
        return loss.detach(), unflatten(dict(zip(paths, grads)))

    def grads_of(params, batch):
        if accum == 1:
            return value_and_grad(params, batch)
        dev = tree_leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=dev), params)
        for mb in _split_micro(batch, accum):
            l, g = value_and_grad(params, mb)
            loss = loss + l
            tree_map(lambda a, b: a.add_(b), grads, g)
            del g
        inv = 1.0 / accum
        return loss * inv, tree_map(lambda g: g * inv, grads)
    return grads_of


def make_train_step(cfg: ModelConfig, *, lr_fn=None, compress: bool = False):
    """``step_fn(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``; with ``compress`` ``step_fn(params, opt_state, comp_state,
    batch, step) -> (params, opt_state, comp_state, metrics)``, the
    gradients int8-compressed with error feedback before AdamW.  ``lr_fn``
    maps the 0-dim int32 step to the rate (3e-4 when None).  The given
    state is not written; metrics are 0-dim tensors ``loss``,
    ``grad_norm`` and ``clip_scale``."""
    grads_of = make_grads_fn(cfg)
    if lr_fn is None:
        lr_fn = lambda step: torch.tensor(3e-4, dtype=torch.float32)  # noqa: E731

    def update(params, opt_state, grads, step, loss):
        params, opt_state, m = optim.adamw_update(grads, opt_state, params,
                                                  lr_fn(step))
        m["loss"] = loss
        return params, opt_state, m

    if compress:
        def step_fn(params, opt_state, comp_state, batch, step):
            loss, grads = grads_of(params, batch)
            grads, comp_state = optim.compressed_gradients(grads, comp_state)
            params, opt_state, m = update(params, opt_state, grads, step,
                                          loss)
            return params, opt_state, comp_state, m
        return step_fn

    def step_fn(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        return update(params, opt_state, grads, step, loss)
    return step_fn


def make_prefill_step(cfg: ModelConfig, pad_to: Optional[int] = None,
                      use_kernel: Optional[bool] = None):
    """``prefill(params, batch) -> (last-position logits, caches)``.
    ``pad_to``: decode-continuation capacity of the returned caches; None
    keeps them at the prompt length (``cache_specs(cfg, B, L)``).  The
    head runs on the last position only: ``repro``'s prefill slices the
    full logits, which XLA computes for that position alone, and the full
    (B, L, vocab) logits would be gemma3-1b's largest tensor."""
    def prefill(params, batch):
        params = cast_params(cfg, params)
        x, caches, _ = _trunk(cfg, params, batch.get("tokens"),
                              batch.get("embeds"), None, True, pad_to,
                              use_kernel)
        return _head(cfg, params, x[:, -1:])[:, 0], caches
    return prefill


def make_decode_step(cfg: ModelConfig, use_kernel: Optional[bool] = None):
    """One-token decode: ``decode(params, caches, batch, pos) -> (logits
    (B, 1, V), caches)`` with ``batch["tokens"]`` (B, 1) and ``pos`` (B,)
    each row's absolute position.  ``params`` must already be cast
    (``cast_params``, once by the caller, never on each tick); the given
    caches are not written."""
    def decode(params, caches, batch, pos):
        x, caches, _ = _trunk(cfg, params, batch.get("tokens"),
                              batch.get("embeds"), None, False, None,
                              use_kernel, caches, pos)
        return _head(cfg, params, x), caches
    return decode


# --------------------------------------------------------------------------
# Input specs (the modality frontend stub: audio archs receive codebook
# token frames, vision archs precomputed patch/text embeddings)
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The inputs of one shape cell as meta tensors (``repro``'s
    ``input_specs``): a train step's batch and labels and its step
    counter, a prefill's batch, or a decode step's one-token batch, its
    caches of ``seq_len`` positions and the per-row positions."""
    B, L = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(sh, dtype=i32):
        return torch.empty(sh, dtype=dtype, device="meta")

    def tok(b, l):
        if cfg.embed_inputs:
            return {"embeds": spec((b, l, cfg.d_model), cfg.cdtype)}
        if cfg.n_codebooks > 1:
            return {"tokens": spec((b, l, cfg.n_codebooks))}
        return {"tokens": spec((b, l))}

    if shape.kind == "train":
        lab = (B, L, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, L)
        return {"batch": {**tok(B, L), "labels": spec(lab)}, "step": spec(())}
    if shape.kind == "prefill":
        return {"batch": tok(B, L)}
    # decode: one new token against a cache of length L
    return {"batch": tok(B, 1), "caches": abstract_cache(cfg, B, L),
            "pos": spec((B,))}
