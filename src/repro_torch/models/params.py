"""Declarative parameter tables (the port's copy of ``repro.models.params``).

Every architecture's parameters are a flat ``{path: ParamSpec}`` table
carrying shape, dtype, logical axis names and an initializer tag; the
concrete tree (``init_params``) and exact parameter counts (``count``)
derive from it.  The tree layout is ``repro``'s, so a ``repro`` parameter
tree converts leaf by leaf (``models/convert.py``).

The initial values are this package's own draws from a seeded
``torch.Generator``, with ``repro``'s distributions per tag; they are not
``repro``'s ``jax.random`` bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical name per dim (None = replicated)
    init: str = "normal"                 # normal | zeros | ones | a_log | dt_bias | small
    dtype: str = "float32"
    scale: float = 1.0                   # fan-in override multiplier

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device) -> torch.Tensor:
    dt = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "a_log":               # mamba: A = -exp(A_log), A_log = log(1..S)
        s = spec.shape[-1]
        a = torch.log(torch.arange(1, s + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(spec.shape).to(dt).contiguous()
    out = torch.empty(spec.shape, dtype=torch.float32, device=device)
    if spec.init == "dt_bias":             # mamba: softplus^-1(uniform(1e-3, 1e-1))
        out.uniform_(1e-3, 1e-1, generator=generator)
        return torch.log(torch.expm1(out)).to(dt)
    # normal / small: truncated normal, 1/sqrt(fan_in) style
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    if len(spec.shape) >= 3:               # stacked/expert weights: fan-in is dim -2
        fan_in = spec.shape[-2]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    if spec.init == "small":
        std = 0.02 * spec.scale
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return out.mul_(std).to(dt)


def unflatten(flat: Dict[Path, object]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def init_params(specs: Dict[Path, ParamSpec], generator: torch.Generator,
                device=None,
                transform: Optional[Callable[[torch.Tensor], torch.Tensor]]
                = None) -> Dict:
    """Draw every leaf in path order on ``device`` from ``generator`` (a
    generator on that device).  ``transform`` is applied to each leaf as
    soon as it is drawn (``model.cast_leaf`` keeps a full-size model's
    float32 masters from ever existing at once)."""
    device = generator.device if device is None else torch.device(device)
    keep = transform or (lambda t: t)
    return unflatten({p: keep(_init_leaf(s, generator, device))
                      for p, s in sorted(specs.items())})


def count(specs: Dict[Path, ParamSpec],
          weight: Callable[[Path, ParamSpec], float] = lambda p, s: 1.0) -> int:
    return int(sum(s.size * weight(p, s) for p, s in specs.items()))
