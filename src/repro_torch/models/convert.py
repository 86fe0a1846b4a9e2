"""Conversion between the JAX package's model trees and this package's.

Both packages lay parameters and caches out alike (``prefix/l{i}``,
stacked ``scan/s{j}``, the same leaf names), so a tree converts leaf by
leaf: ``params_from_numpy`` takes ``repro``'s parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``), ``caches_from_numpy``
does the same for a cache tree (``repro``'s prefill caches continue in
the port's decode step) and ``caches_to_numpy`` gives the port's caches
back as numpy for comparison.  ``train_state_from_numpy`` takes
``repro``'s train state (``{"params", "opt": AdamWState, "comp", "step"}``
of numpy arrays) so both packages can train from one state, and
``train_state_to_numpy`` gives the port's back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """``repro``'s parameter (or cache) tree of numpy arrays -> the same
    tree of tensors on ``device``, values and dtypes unchanged."""
    return _map(lambda a: _to_torch(a, device), tree)


def caches_from_numpy(tree: Dict, device="cpu") -> Dict:
    """``repro``'s cache tree of numpy arrays -> the port's, on ``device``,
    values and dtypes unchanged (bf16 leaves stay bf16): the inverse of
    :func:`caches_to_numpy` up to its bf16 upcast."""
    return params_from_numpy(tree, device)


def caches_to_numpy(tree: Dict) -> Dict:
    """The port's cache (or parameter) tree -> numpy on the host; bf16
    leaves come back as float32 (exactly: every bf16 is a float32)."""
    return _map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                .detach().cpu().numpy(), tree)


def train_state_from_numpy(state: Dict, device="cpu") -> Dict:
    """``repro``'s train state of numpy arrays (``jax.tree.map(np.asarray,
    state)``: the optimiser state a NamedTuple with ``mu``, ``nu`` and
    ``count``, the compression state one with ``error`` or None) -> the
    port's, tensors on ``device`` with ``step`` kept as a numpy int32, as
    both trainers keep it.  The checkpoint leaf names stay ``repro``'s."""
    from repro_torch.optim import AdamWState, CompressionState
    opt, comp = state["opt"], state.get("comp")
    return {
        "params": params_from_numpy(state["params"], device),
        "opt": AdamWState(params_from_numpy(opt.mu, device),
                          params_from_numpy(opt.nu, device),
                          _to_torch(opt.count, device)),
        "comp": (None if comp is None else
                 CompressionState(params_from_numpy(comp.error, device))),
        "step": np.asarray(int(state["step"]), np.int32)}


def train_state_to_numpy(state: Dict) -> Dict:
    """The port's train state -> the same structure (the port's
    NamedTuples) of numpy arrays on the host: the inverse of
    :func:`train_state_from_numpy`."""
    from repro_torch.optim import AdamWState, CompressionState
    opt, comp = state["opt"], state.get("comp")
    return {
        "params": caches_to_numpy(state["params"]),
        "opt": AdamWState(caches_to_numpy(opt.mu), caches_to_numpy(opt.nu),
                          caches_to_numpy(opt.count)),
        "comp": (None if comp is None else
                 CompressionState(caches_to_numpy(comp.error))),
        "step": np.asarray(int(state["step"]), np.int32)}
