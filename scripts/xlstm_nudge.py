#!/usr/bin/env python3
"""How far xlstm-1.3b's plain float32 prefill moves when its token
embeddings move up by one unit in the last place.

For each configuration below (the published widths unless noted, cut in
depth, length or layer kinds), the port's ``make_prefill_step`` runs
through the plain torch versions (``use_kernel=False``) in float32 twice
on the same seeded weights and prompt: as drawn, and with every element
of the embedding table moved to the next float32 toward +inf.  It prints
one line per configuration: the logits' max |diff| / max |plain| and the
worst cache leaf's.  A kernel that reorders float32 sums cannot be held
closer to the plain version than the model holds itself.

    python3 scripts/xlstm_nudge.py [--device cuda] [--batch 2] [--seed 0]
    python3 scripts/xlstm_nudge.py --device cpu --only 5   # the narrow row
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, layers, pattern, length, d_model); pattern None keeps the
# published one (1 sLSTM and 7 mLSTM a period)
CONFIGS = (("8, one period", 8, None, 1024, None),
           ("8, one period", 8, None, 4096, None),
           ("16, two periods", 16, None, 1024, None),
           ("8, mLSTM only", 8, "mlstm", 1024, None),
           ("8, sLSTM only", 8, "slstm", 1024, None),
           ("8, one period, d_model 256", 8, None, 1024, 256))


def leaves(tree, prefix=""):
    """(path, tensor) for every leaf of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def ratio(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp_min(1e-30)).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", type=int, default=None,
                    help="run only this row of CONFIGS (0-based)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.config import MLSTM, NONE, SLSTM
    from repro_torch.models.model import make_prefill_step, param_specs
    from repro_torch.models.params import init_params
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = CONFIGS if args.only is None else (CONFIGS[args.only],)
    for label, n_layers, kind, L, width in rows:
        cfg = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=n_layers,
                                  compute_dtype="float32")
        if kind is not None:
            cfg = dataclasses.replace(
                cfg, pattern=(({"mlstm": MLSTM, "slstm": SLSTM}[kind], NONE),))
        if width is not None:
            cfg = dataclasses.replace(cfg, d_model=width)
        cfg = cfg.validate()
        params = init_params(param_specs(cfg),
                             torch.Generator(device=dev).manual_seed(args.seed),
                             dev)
        tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (args.batch, L))).to(dev)
        step = make_prefill_step(cfg, use_kernel=False)
        plain = step(params, {"tokens": tokens})
        tok = params["embed"]["tok"]
        params["embed"]["tok"] = torch.nextafter(tok, torch.full_like(
            tok, float("inf")))
        nudged = step(params, {"tokens": tokens})
        worst = max((ratio(g, w), p) for (p, g), (_, w) in zip(
            leaves(nudged[1]), leaves(plain[1])))
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"{label}; L {L}; B {args.batch}; float32 plain on {name}: "
              f"logits {ratio(nudged[0], plain[0])}, worst cache leaf "
              f"{worst[0]} ({worst[1]})", flush=True)
        del params, plain, nudged, tok
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
