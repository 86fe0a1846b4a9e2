#!/usr/bin/env python3
"""Where the time of one engine round of the PyTorch/CUDA port goes.

Builds the smoke cell of ``chip_smoke.py`` (EngineConfig defaults,
4,096 streams), warms the round up, then runs ``--rounds`` rounds of the
chosen path under ``torch.profiler`` and prints one JSON line: host wall
ms per round, device busy ms per round (the sum of the CUDA kernels' and
copies' own device time — one stream, so they do not overlap), the
device's idle share, CUDA launches per round, and the kernels that take
the most device time.  ``--superstep K`` runs the same rounds as
supersteps of K (posts at each boundary, one spool readback each);
``--shards D`` runs the sharded engine (D shards emulated on the card,
``exchange_slots=0``).  Needs one CUDA device; fails without one.

    python3 scripts/profile_torch_round.py [--path fused|staged] \
        [--rounds 16] [--superstep K] [--shards D]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_events(prof, torch):
    """The profiled events that ran on the card (kernels and copies)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def drive_supersteps(torch, eng, sources, rounds, seed, per_round, K):
    """``rounds // K`` supersteps of K rounds, each after posting what K
    rounds of ``chip_smoke.drive`` would (``per_round`` SUs to distinct
    sources per round), each read back once; returns (spools, wall
    seconds)."""
    import time
    import numpy as np
    rng = np.random.default_rng(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for s in range(rounds // K):
        for r in range(s * K, (s + 1) * K):
            for j in rng.choice(len(sources), per_round, replace=False):
                eng.post(sources[j], rng.standard_normal(4).tolist(),
                         r * 10 + int(rng.integers(0, 9)))
        out.append(eng.spool_sinks(eng.superstep(K)))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_round(torch, cs, eng, sources, rounds: int, warmup: int,
                  superstep: int = 0):
    """Time ``rounds`` rounds of ``eng`` unprofiled, then the same count
    under ``torch.profiler``; returns the summary dict.  ``superstep=K``
    runs the rounds as supersteps of K (``rounds`` a multiple of K)."""
    from torch.profiler import ProfilerActivity, profile
    B = eng.cfg.batch

    def run(n, seed):
        if superstep:
            return drive_supersteps(torch, eng, sources, n, seed, B,
                                    superstep)
        return cs.drive(torch, eng, sources, n, seed, B)

    run(warmup, cs.SEED + 1)
    _, wall = run(rounds, cs.SEED + 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = run(rounds, cs.SEED + 3)
    events = device_events(prof, torch)
    per_name = {}
    for e in events:
        t, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    busy_ms = sum(t for t, _ in per_name.values()) / rounds / 1e3
    prof_ms = wall_prof / rounds * 1e3
    return {
        "path": eng._path, "rounds": rounds, "superstep": superstep or 1,
        "wall_ms_per_round": wall / rounds * 1e3,
        "profiled_wall_ms_per_round": prof_ms,
        "device_busy_ms_per_round": busy_ms if events else None,
        "device_idle_share": (1 - busy_ms / prof_ms) if events else None,
        "unprofiled_idle_share": (1 - busy_ms / (wall / rounds * 1e3))
        if events else None,
        "device_events_per_round": len(events) / rounds,
        "top_kernels": [{"name": k[:80], "ms_per_round": t / rounds / 1e3,
                         "calls_per_round": n / rounds}
                        for k, (t, n) in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("fused", "staged"), default="fused")
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--superstep", type=int, default=0,
                    help="run the rounds as supersteps of this K")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards of the sharded engine (1: single device)")
    args = ap.parse_args()
    if args.superstep and (args.rounds % args.superstep
                           or args.warmup % args.superstep):
        sys.exit("profile_torch_round: --rounds and --warmup must be "
                 "multiples of --superstep")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_round: CUDA is not available")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import EngineConfig, create_engine

    cfg = EngineConfig(n_streams=4096, n_shards=args.shards,
                       exchange_slots=0).validate()
    reg, sources = cs.build_registry(cfg, np.random.default_rng(cs.SEED))
    if args.path == "staged":
        reg.create_composite(reg.tenants[0], "hot", cs.CHANNELS, sources[:2],
                             {ch: f"tanh(in0.{ch}) + in1.{ch}"
                              for ch in cs.CHANNELS})
    eng = create_engine(reg, device=torch.device("cuda", 0))
    if eng._path != args.path:
        sys.exit(f"profile_torch_round: engine took the {eng._path} path")
    out = profile_round(torch, cs, eng, sources, args.rounds, args.warmup,
                        args.superstep)
    out["shards"] = args.shards
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
