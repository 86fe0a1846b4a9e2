#!/usr/bin/env python3
"""Where the cycles of the sharded round's ``apply_programs`` go on the card.

Builds the 4-shard smoke cell of ``chip_smoke.py`` (EngineConfig defaults,
4,096 streams, ``exchange_slots=0``), drives ``--heavy`` rounds of 64
posted SUs, and records the inputs of one more round's
``apply_programs_call`` (as chip_smoke phase 13 records them).  Then it
builds ``csrc/fused_round.cu`` with ``nvcc`` (the port's flags) and a
header that reads the SM cycle counter at the kernel's ``APPLY_STAMP``
points (lane 0 of every warp, after a ``__syncwarp``), checks the
outputs against the plain version bit for bit, and prints one JSON line
per input: the kernel's ms (CUDA events over 200 back-to-back launches
of the stamped build; the stamps cost a few stores a warp), and per warp
the cycles of each stage — trip 1 (the item and its event), trip 2 (its
program, constants, co-input ids and target value staged in shared
memory), the trigger slot and the warp's step count, trip 3 (the
co-inputs), the VM, and the epilogue — as mean, median and max over the
warps, with the warps' VM steps.
The inputs run twice: as recorded, and with each warp's lanes all on its
first lane's row ("uniform"), which keeps the mix of programs across
warps but takes the opcode switch's divergence within a warp away.
Needs one CUDA device; fails without one.

    python3 scripts/profile_torch_apply.py [--heavy 24]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/round_fuse/csrc/fused_round.cu"
MAX_WARPS = 4096
STAGES = ("trip 1", "trip 2", "trigger and trip 3", "program and steps",
          "vm", "epilogue")
N_STAMPS = len(STAGES) + 1
HEADER = r"""
#include <cuda_runtime.h>
#define APPLY_MAX_WARPS %d
__device__ long long g_apply_stamps[APPLY_MAX_WARPS * %d];
#define APPLY_STAMP(k)                                                    \
  do {                                                                    \
    __syncwarp();                                                         \
    const int gw_ = (blockIdx.y * gridDim.x + blockIdx.x) *               \
                        (blockDim.x / 32) + threadIdx.x / 32;             \
    if ((threadIdx.x & 31) == 0 && gw_ < APPLY_MAX_WARPS) {               \
      g_apply_stamps[gw_ * %d + (k)] = clock64();                          \
    }                                                                     \
  } while (0)
extern "C" int apply_stamps(long long* stamps) {
  return (int)cudaMemcpyFromSymbol(
      stamps, g_apply_stamps, sizeof(long long) * APPLY_MAX_WARPS * %d);
}
""" % (MAX_WARPS, N_STAMPS, N_STAMPS, N_STAMPS)


def build():
    """The stamped build of fused_round.cu, its launcher typed as
    ``kernel._lib`` types the port's; returns the loaded library."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "apply_profile"
    out.mkdir(parents=True, exist_ok=True)
    header = out / "stamp.h"
    header.write_text(HEADER)
    lib_path = out / "apply_profile.so"
    res = subprocess.run([_build._nvcc(), *_build.FLAGS,
                          "-include", str(header),
                          "-o", str(lib_path), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.apply_programs_launch.argtypes = [ctypes.POINTER(I)] + [I] * 7 + \
        [P] * 21
    lib.apply_programs_launch.restype = I
    lib.apply_stamps.argtypes = [P]
    return lib


def record_inputs(torch, cs, heavy: int):
    """The arguments of one ``apply_programs_call`` of the 4-shard smoke
    cell after ``heavy`` heavy rounds (chip_smoke's ``drive``)."""
    import numpy as np
    from repro_torch.core import EngineConfig, create_engine
    from repro_torch.kernels.round_fuse import kernel as rk
    cfg = EngineConfig(n_streams=4096, n_shards=cs.SHARDS,
                       exchange_slots=0).validate()
    reg, sources = cs.build_registry(cfg, np.random.default_rng(cs.SEED))
    eng = create_engine(reg, device=torch.device("cuda", 0))
    cs.drive(torch, eng, sources, heavy, cs.SEED + 12, cfg.batch)
    args, _ = cs.record_plans(torch, eng, sources, rk,
                              ("apply_programs",))["apply_programs"]
    return args


def uniform_rows(args):
    """``args`` with every warp's items on its first item's row and
    target (32 consecutive items of a shard)."""
    rows, t_sid = args[6].clone(), args[7].clone()
    first = (rows.new_tensor(range(rows.shape[1])) // 32) * 32
    rows[:] = rows[:, first.long()]
    t_sid[:] = t_sid[:, first.long()]
    return args[:6] + (rows, t_sid) + args[8:]


def warp_steps(progs, rows):
    """Each warp's VM steps: one past the last non-NOP instruction of any
    of its lanes' programs (lanes past W run item W - 1), warps in the
    kernel's order (shard-major, 32 items a warp)."""
    import torch
    S, W = rows.shape
    pad = (W + 31) // 32 * 32
    idx = torch.clamp(torch.arange(pad, device=rows.device), max=W - 1)
    ops = torch.stack([progs[s][rows[s, idx].long()][..., 0]
                       for s in range(S)])                  # (S, pad, L)
    L = ops.shape[-1]
    pcs = torch.arange(1, L + 1, device=ops.device)
    last = torch.where(ops != 0, pcs, 0).max(dim=-1).values
    return last.view(S, pad // 32, 32).max(dim=-1).values.reshape(-1)


def profile(torch, cs, lib, args, tag):
    """Run the stamped build on ``args``: check it against the plain
    version, time it, and summarise the stamps per stage."""
    import numpy as np
    from repro_torch.kernels.round_fuse import kernel as rk
    from repro_torch.kernels.round_fuse.ops import apply_programs
    own = rk._lib
    rk._lib = lambda: lib              # the stamped build, typed alike
    try:
        launch, out = rk.plan_apply_programs(*args)
    finally:
        rk._lib = own
    launch()
    torch.cuda.synchronize()
    cs.compare(f"apply_programs ({tag})", out,
               apply_programs(*args, use_kernel=False))
    ms, host = cs.time_launches([launch], 200)
    launch()
    torch.cuda.synchronize()
    stamps = np.zeros(MAX_WARPS * N_STAMPS, np.int64)
    err = lib.apply_stamps(stamps.ctypes.data_as(ctypes.c_void_p))
    if err != 0:
        sys.exit(f"reading the stamps: CUDA error {err}")
    steps = warp_steps(args[2], args[6]).cpu().numpy()
    n_warps = steps.size
    if n_warps > MAX_WARPS:
        sys.exit(f"{n_warps} warps: the stamps hold {MAX_WARPS}")
    st = stamps[:n_warps * N_STAMPS].reshape(n_warps, N_STAMPS)
    d = np.diff(st, axis=1)
    stages = {name: {"mean": float(d[:, k].mean()),
                     "median": float(np.median(d[:, k])),
                     "max": int(d[:, k].max())}
              for k, name in enumerate(STAGES)}
    total = st[:, -1] - st[:, 0]
    return {"input": tag, "ms": ms, "prog_len": int(args[2].shape[-2]),
            "host_enqueue_ms": host, "warps": n_warps,
            "cycles_per_warp": {"mean": float(total.mean()),
                                "median": float(np.median(total)),
                                "max": int(total.max())},
            "stages": stages,
            "vm_steps": {"mean": float(steps.mean()),
                         "max": int(steps.max())},
            "vm_cycles_per_step": float(d[:, STAGES.index("vm")].sum() / max(
                int(steps.sum()), 1))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heavy", type=int, default=24)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_apply: CUDA is not available")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    inputs = record_inputs(torch, cs, args.heavy)
    lib = build()
    for tag, a in (("recorded", inputs), ("uniform", uniform_rows(inputs))):
        out = profile(torch, cs, lib, a, tag)
        out["device"] = torch.cuda.get_device_name(0)
        out["card"] = cs.nvidia_smi()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
