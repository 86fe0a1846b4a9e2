"""AdamW with global-norm clipping on parameter trees (the port of
``repro.optim.adamw``).

A tree is nested dicts of tensors, walked in sorted key order (the
checkpoint flatten's order, ``jax.tree.leaves``' order), so the global
norm sums its per-leaf terms in ``repro``'s order.  The update is
functional, as ``repro``'s: it returns new parameter and moment tensors
and writes none it was given.  Weight decay applies to every leaf of two
or more dims, which includes the stacked ``scan/*`` norm gammas and
biases (``repro``'s rule, kept as it is).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Dict) -> AdamWState:
    """Zero float32 moments beside each leaf and a zero int32 count."""
    device = tree_leaves(params)[0].device
    return AdamWState(mu=tree_map(_zeros, params), nu=tree_map(_zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the Python sum, in leaf order, of each leaf's float32 sum
    of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (new_params, new_state, metrics): the gradients scaled to
    a global norm of at most ``clip_norm``, bias-corrected moments (the
    corrections ``b ** count`` in float32) and decoupled weight decay on
    every leaf of two or more dims.  ``lr`` is a number or a 0-dim
    tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m1 = b1 * m + (1.0 - b1) * g
        v1 = b2 * v + (1.0 - b2) * g * g
        step = (m1 / c1) / (torch.sqrt(v1 / c2) + eps)
        decay = weight_decay if p.dim() >= 2 else 0.0
        p1 = p.float() - lr * (step + decay * p.float())
        return p1.to(p.dtype), m1, v1

    out = tree_map(upd, grads, state.mu, state.nu, params)

    def pick(i):
        return tree_map(lambda t: t[i], out)

    return pick(0), AdamWState(pick(1), pick(2), count), {
        "grad_norm": gnorm, "clip_scale": scale}
