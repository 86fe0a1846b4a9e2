#!/usr/bin/env python3
"""How ``window_agg``'s ring depth, chunk length and fold set its time.

Builds, with ``nvcc`` and the port's flags, copies of
``window_agg/csrc/window_agg.cu`` that differ from the shipped source in
one constant or one line each, all at once:

* ``stages S`` (S in 2, 3, 4, 6, 8): a ring of S stages (the source's
  ``kStages`` is 3);
* ``fold sum only``: the fold's max and min taken out (its ``max`` and
  ``min`` outputs are then not compared);
* ``fold selects``: the NaN-aware max and min as branch-free selects in
  C++ instead of PTX ``max.NaN.f32`` / ``min.NaN.f32``.

It also times the shipped build at chunks of 32 and 128 entries (the
plan's is 64), by launching it with a plan of that chunk.  Each variant runs on
two stores drawn from the seed: (4096, 1024, 4) with every window full,
and (3586, 256, 4), the IoT suite's width, with counts of 0 to 2; each is
held against the plain version bit for bit first (every output but
those a variant drops; the line says whether it matched), then timed by CUDA events over 200 back-to-back
launches and by ``torch.profiler``.  Prints one JSON line a variant and
store, and the card's name and power limit.  Needs one CUDA device; fails
without one.

    python3 scripts/profile_torch_window_agg.py
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/window_agg/csrc"
SOURCE = CSRC / "window_agg.cu"
STAGES = int(re.search(r"constexpr int kStages = (\d+);",
                     SOURCE.read_text()).group(1))     # the source's ring
SELECTS = r"""
__device__ __forceinline__ float ieee_max(float a, float b) {
  const bool nan = a != a || b != b;
  const bool pick_a = a > b || (a == b && !(__float_as_uint(a) >> 31));
  return nan ? a + b : (pick_a ? a : b);
}

__device__ __forceinline__ float ieee_min(float a, float b) {
  const bool nan = a != a || b != b;
  const bool pick_a = a < b || (a == b && (__float_as_uint(a) >> 31));
  return nan ? a + b : (pick_a ? a : b);
}
"""


def stages_edit(src: str, stages: int) -> str:
    """The source with a ring of ``stages`` stages and the counts and ring
    after that many mbarriers."""
    offset = -(-(8 * stages + 128) // 16) * 16
    for pat, new in ((r"constexpr int kStages = \d+;",
                      f"constexpr int kStages = {stages};"),
                     (r"constexpr int kRingOffset = \d+;",
                      f"constexpr int kRingOffset = {offset};")):
        src, n = re.subn(pat, new, src)
        assert n == 1, pat
    return src


def sum_only_edit(src: str) -> str:
    for line in ("mx = ieee_max(mx, y);", "mn = ieee_min(mn, y);"):
        assert src.count(line) == 2, line
        src = src.replace(line, "")
    return src


def selects_edit(src: str) -> str:
    a = src.index("__device__ __forceinline__ float ieee_max(")
    b = src.index("__device__ __forceinline__ void cp_async4(")
    return src[:a] + SELECTS + "\n" + src[b:]


VARIANTS = {  # name: (edit of the source, ring stages, outputs it drops)
    **{f"stages {s}": (lambda t, s=s: stages_edit(t, s), s, ())
       for s in (2, 3, 4, 6, 8)},
    "fold sum only": (sum_only_edit, STAGES, ("max", "min")),
    "fold selects": (selects_edit, STAGES, ()),
}


def build_all():
    """Every variant's library, ``nvcc`` started for all at once."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "window_agg_profile"
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for i, (name, (edit, _, _)) in enumerate(VARIANTS.items()):
        src, lib = out / f"variant{i}.cu", out / f"variant{i}.so"
        src.write_text(edit(text))
        # "../../csrc/hopper.cuh" resolves against the source's own folder
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", str(CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        lib.window_agg_launch.argtypes = [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6
        libs[name] = lib
    return libs


def plan_for(K, N, W, C, chunk, stages):
    """The shipped plan with ``chunk`` entries a chunk and ``stages``
    ring stages (the shared bytes as the variant's source checks them)."""
    plan = K.window_agg_plan(N, W, C)
    G = plan.streams_per_warp
    pitch = -(-chunk * C * 4 // 16) * 16
    pitch += (16 - pitch % 128) % 128
    offset = -(-(8 * stages + 128) // 16) * 16
    return plan._replace(chunk=chunk, pitch=pitch,
                         smem_bytes=offset + stages * G * pitch)


def launcher(torch, K, lib, vals, cnt, plan):
    from repro_torch.kernels import _build
    from repro_torch.kernels.window_agg.ref import AGGREGATES
    N, W, C = vals.shape
    outs = {k: torch.empty((N, C), device=vals.device) for k in AGGREGATES}
    args = (_build.ptr(vals), _build.ptr(cnt), N, W, C, plan.chunk,
            plan.pitch, plan.streams_per_warp, plan.warps_per_stream,
            K.STAGINGS.index(plan.staging), plan.blocks, plan.smem_bytes,
            *[_build.ptr(outs[k]) for k in AGGREGATES],
            _build.stream_ptr(vals.device))

    def launch():
        _build.check(lib.window_agg_launch(*args), "window_agg variant")
    return launch, outs


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_window_agg: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.window_agg import kernel as K
    from repro_torch.kernels.window_agg.ops import window_agg
    dev = torch.device("cuda", 0)
    libs = build_all()
    shipped = _build.load("window_agg")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    stores = {
        "full (4096, 1024, 4)": (
            torch.randn((4096, 1024, 4), generator=gen, device=dev),
            torch.full((4096,), 1024, dtype=torch.int32, device=dev)),
        "suite width (3586, 256, 4), counts 0-2": (
            torch.randn((3586, 256, 4), generator=gen, device=dev),
            torch.randint(0, 3, (3586,), generator=gen, device=dev,
                          dtype=torch.int32))}
    runs = [(name, libs[name], stages, 64, drops)
            for name, (_, stages, drops) in VARIANTS.items()]
    runs += [(f"shipped, chunk {k}", shipped, K.STAGES, k, ())
             for k in (32, 128)]
    K._lib()                                    # types the shipped launcher
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for tag, (vals, cnt) in stores.items():
        want = window_agg(vals, cnt, use_kernel=False)
        for name, lib, stages, chunk, drops in runs:
            N, W, C = vals.shape
            plan = plan_for(K, N, W, C, chunk, stages)
            launch, got = launcher(torch, K, lib, vals, cnt, plan)
            launch()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(got[k].view(torch.int32),
                                      want[k].view(torch.int32))
                          for k in want if k not in drops)
            ms, ev, host, prof, src = cs.launch_ms(launch,
                                                   "window_agg_kernel")
            print(json.dumps({"store": tag, "variant": name,
                              "chunk": chunk, "stages": stages,
                              "blocks": plan.blocks,
                              "smem_bytes": plan.smem_bytes,
                              "bitwise": bitwise, "ms": ms,
                              "taken": src, "events_ms": ev,
                              "host_ms": host, "profiler_ms": prof}),
                  flush=True)


if __name__ == "__main__":
    main()
