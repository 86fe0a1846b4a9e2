"""Serving launcher: continuous-batching decode over a chosen arch (the
port of ``repro.launch.serve``), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --smoke --requests 8 --slots 4

Weights are drawn from ``--seed`` on the device, in the config's compute
dtype.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.serving import ContinuousBatcher, Request


def main(argv: Optional[List[str]] = None) -> List[Request]:
    """Parse ``argv`` (``sys.argv`` when None), serve the requests and
    print the throughput; returns the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if cfg.n_codebooks > 1 or cfg.embed_inputs:
        raise SystemExit(f"{args.arch}: modality-frontend arch; the token "
                         f"batcher serves text archs (see serving/bridge.py)")
    dev = resolve_device(args.device)
    params = init_params(M.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(args.seed),
                         dev, transform=lambda t: M.cast_leaf(cfg, t))
    b = ContinuousBatcher(cfg, params, slots=args.slots,
                          max_len=args.max_len, device=dev)
    for i in range(args.requests):
        b.submit(Request(rid=i, prompt=[2 + i, 7, 11 + i],
                         max_tokens=args.max_tokens))
    t0 = time.perf_counter()
    done = b.run_until_drained()
    dt = time.perf_counter() - t0
    tok = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s, {b.ticks} engine ticks)")
    for r in done[:4]:
        print(f"  rid={r.rid} output={r.output}")
    return done


if __name__ == "__main__":
    main()
