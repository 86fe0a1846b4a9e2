#!/usr/bin/env python3
"""How ``selective_scan``'s ring sizes and paths set its time.

Builds, with ``nvcc`` and the port's flags, copies of
``selective_scan/csrc/selective_scan.cu`` whose ring differs from the
shipped one in its steps a chunk and its stages (the source's ``kT`` and
``kStages``), all at once, and times at jamba's Mamba layer
(B 1, L 4,096, Di 8,192, S 16):

* each variant at rows of 512, 256 and 128 floats (C = 32, 16, 8
  channels a CTA; the plan takes one of the first two);
* the shipped build on its register path at the same shape, with four
  states a thread and with one (what the ring replaces at long L);
* with ``--parent FILE``, an earlier ``selective_scan.cu`` (the entry of
  one thread a state: a, bx, c, h0, y, hout, B, L, Di, S, stream), here
  and at the decode shape, in the same call;
* ``torch.sum`` over a and over bx, as a yardstick of the read rate the
  card reaches.

Every launch is first held bit for bit against the shipped plan's output
(the arithmetic and the order of y's sum do not depend on the ring's
sizes or the path; the one-state template sums y in another order, so
there only h is bitwise), and the shipped plan against the plain version
within 1e-4.  Then, at jamba's decode shape (B 4, L 1, Di 8,192, S 16): CUDA
events over 200 back-to-back launches beside the host's enqueue time per
launch, the same 200 launches replayed from one CUDA graph (the device's
own back-to-back time, with no host in between) and ``torch.profiler``'s
device time; and the host's microseconds a call of the ctypes entry
refusing its arguments, of the entry launching, of the plan's launch and
of a one-element torch kernel.  Prints one JSON
line a measurement and the card's name and power limit.  Needs one CUDA
device; fails without one.

    python3 scripts/profile_torch_selective_scan.py [--parent FILE]
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/selective_scan/csrc"
SOURCE = CSRC / "selective_scan.cu"
# (steps a chunk, stages); the shipped source's is RING_STEPS, RING_STAGES
VARIANTS = ((4, 4), (8, 2), (8, 3), (8, 4), (16, 2), (16, 3))
PREFILL = (1, 4096, 8192, 16)
DECODE = (4, 1, 8192, 16)
NAME = "selective_scan_"      # both kernels' profiler names start so


def ring_edit(src: str, T: int, stages: int) -> str:
    """The source with a ring of ``stages`` stages of ``T`` steps."""
    for pat, new in ((r"constexpr int kT = \d+;", f"constexpr int kT = {T};"),
                     (r"constexpr int kStages = \d+;",
                      f"constexpr int kStages = {stages};")):
        src, n = re.subn(pat, new, src)
        assert n == 1, pat
    return src


def build_variants():
    """Every variant's library, ``nvcc`` started for all at once."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "selective_scan_profile"
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for T, stages in VARIANTS:
        src = out / f"scan_T{T}_S{stages}.cu"
        lib = src.with_suffix(".so")
        src.write_text(ring_edit(text, T, stages))
        # "../../csrc/hopper.cuh" resolves against the source's own folder
        procs[(T, stages)] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", str(CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for key, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        lib.selective_scan_launch.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.selective_scan_launch.restype = ctypes.c_int
        libs[key] = lib
    return libs


def ring_plan(K, S, B, Di, C, T, stages):
    """A ring plan of C channels a CTA for a source of T steps a chunk and
    ``stages`` stages (the shared bytes as that source checks them)."""
    smem = K.RING_OFFSET + 4 * (stages * (2 * T * C * S + T * S)
                                + 2 * T * C)
    return K.SelectiveScanPlan("ring", 4, C, C * S // 4, (-(-Di // C), B),
                               smem)


def launcher(torch, lib, args, plan):
    from repro_torch.kernels import _build
    a, bx, c, h0 = args
    B, L, Di, S = a.shape
    y = torch.empty((B, L, Di), device=a.device)
    h = torch.empty((B, Di, S), device=a.device)
    cargs = (*(_build.ptr(t) for t in (a, bx, c, h0, y, h)), B, L, Di, S,
             int(plan.path == "ring"), plan.states, plan.channels,
             plan.smem_bytes, _build.stream_ptr(a.device))

    def launch(keep_alive=(a, bx, c, h0, y, h)):
        _build.check(lib.selective_scan_launch(*cargs), "selective_scan")
    return launch, (y, h)


def parent_build(path):
    """The library of an earlier ``selective_scan.cu`` (its entry takes
    a, bx, c, h0, y, hout, B, L, Di, S, stream), or None."""
    if path is None:
        return None
    from repro_torch.kernels import _build
    lib_path = _build.BUILD_DIR.parent / "selective_scan_profile" / "parent.so"
    log = subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", str(CSRC),
                          "-o", str(lib_path), str(path)],
                         capture_output=True, text=True)
    if log.returncode != 0:
        sys.exit(f"nvcc failed on the parent source:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.selective_scan_launch.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_launch.restype = ctypes.c_int
    return lib


def parent_launcher(torch, lib, args):
    from repro_torch.kernels import _build
    a, bx, c, h0 = args
    B, L, Di, S = a.shape
    y = torch.empty((B, L, Di), device=a.device)
    h = torch.empty((B, Di, S), device=a.device)
    cargs = (*(_build.ptr(t) for t in (a, bx, c, h0, y, h)), B, L, Di, S,
             _build.stream_ptr(a.device))

    def launch(keep_alive=(a, bx, c, h0, y, h)):
        _build.check(lib.selective_scan_launch(*cargs), "parent scan")
    return launch, (y, h)


def host_us(fn, n=2000) -> float:
    """Host microseconds a call of ``fn`` over ``n`` calls."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e6 / n


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_selective_scan: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import kernel as K
    from repro_torch.kernels.selective_scan.ops import selective_scan
    dev = torch.device("cuda", 0)
    parent_src = sys.argv[sys.argv.index("--parent") + 1] \
        if "--parent" in sys.argv else None
    libs = build_variants()
    parent = parent_build(parent_src)
    shipped = K._lib()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def cost(B, L, Di, S):
        n_bytes = (2 * B * L * Di * S + B * L * S + 2 * B * Di * S
                   + B * L * Di) * 4
        return cs.bound_ms(n_bytes, 4 * B * L * Di * S, 0.0)[0]

    B, L, Di, S = PREFILL
    args = cs.scan_inputs(torch, gen, B, L, Di, S)
    launch, (y0, h0) = K.plan_selective_scan(*args)
    launch()
    torch.cuda.synchronize()
    wy, wh = selective_scan(*args, use_kernel=False)
    err = max(cs.close_or_fail("prefill y", y0, wy, 1e-4),
              cs.close_or_fail("prefill h", h0, wh, 1e-4))
    del wy, wh
    bound = cost(B, L, Di, S)
    # a yardstick of the read rate the card reaches: torch's sum over a
    # and over bx (each 2.1 GB, read once)
    total = torch.empty((), device=dev)
    every = (0, 1, 2, 3)
    ev, _ = cs.time_launches(
        [lambda: torch.sum(args[0], dim=every, out=total),
         lambda: torch.sum(args[1], dim=every, out=total)], 10, warmup=2)
    sum_bytes = 2 * args[0].numel() * 4
    print(json.dumps({"shape": PREFILL, "plan": launch.plan._asdict(),
                      "max_abs_err_vs_plain": err, "bound_ms": bound,
                      "torch_sum_of_a_and_bx_ms": ev,
                      "torch_sum_TB_per_s": sum_bytes / (ev * 1e-3) / 1e12}),
          flush=True)
    runs = [(f"ring T {T} stages {st}, C {C}", libs[(T, st)],
             ring_plan(K, S, B, Di, C, T, st))
            for T, st in VARIANTS for C in (512 // S, 256 // S, 128 // S)
            if ring_plan(K, S, B, Di, C, T, st).smem_bytes <= K.SMEM_LIMIT]
    if parent is not None:
        runs.append(("parent", parent, None))
    runs += [(f"register, {v} states a thread", shipped,
              K.SelectiveScanPlan("register", v, K.REGISTER_THREADS // (S // v),
                                  K.REGISTER_THREADS, (0, B), 0))
             for v in (4, 1)]
    for name, lib, plan in runs:
        launch, (y, h) = (parent_launcher(torch, lib, args) if plan is None
                          else launcher(torch, lib, args, plan))
        launch()
        torch.cuda.synchronize()
        y_bits, h_bits = (bool(torch.equal(u.view(torch.int32),
                                           w.view(torch.int32)))
                          for u, w in ((y, y0), (h, h0)))
        ev, host = cs.time_launches([launch], 20, warmup=3)
        prof = cs.profile_kernels([launch], [NAME], n=10)[NAME]
        print(json.dumps({"shape": PREFILL, "variant": name,
                          "plan": plan and plan._asdict(),
                          "y_bitwise_vs_shipped_plan": y_bits,
                          "h_bitwise_vs_shipped_plan": h_bits,
                          "events_ms": ev, "host_ms": host,
                          "profiler_ms": prof,
                          "share_of_bound_events": bound / ev,
                          "share_of_bound_profiler":
                              bound / prof if prof else None}), flush=True)
        del y, h
    del args, y0, h0
    torch.cuda.empty_cache()

    B, L, Di, S = DECODE
    args = cs.scan_inputs(torch, gen, B, L, Di, S)
    launch, (y, h) = K.plan_selective_scan(*args)
    launch()
    torch.cuda.synchronize()
    wy, wh = selective_scan(*args, use_kernel=False)
    err = max(cs.close_or_fail("decode y", y, wy, 1e-4),
              cs.close_or_fail("decode h", h, wh, 1e-4))
    bound = cost(B, L, Di, S)
    # the host's parts of a launch: the ctypes call into an entry that
    # refuses its arguments at once (B = 0), the same entry launching, and
    # a one-element torch kernel for the host's own launch rate
    fn = shipped.selective_scan_launch
    cargs = [*(_build.ptr(t) for t in (*args, y, h)), B, L, Di, S, 0,
             launch.plan.states, launch.plan.channels, 0,
             _build.stream_ptr(dev)]
    refused = list(cargs)
    refused[6] = 0
    one = torch.zeros(1, device=dev)
    host = {"ctypes call, refused at once": host_us(lambda: fn(*refused)),
            "ctypes call and launch": host_us(lambda: fn(*cargs)),
            "plan's launch()": host_us(launch),
            "torch one-element add_": host_us(lambda: one.add_(1.0))}
    torch.cuda.synchronize()
    kinds = [("shipped", lambda: K.plan_selective_scan(*args)[0])]
    if parent is not None:
        kinds.append(("parent", lambda: parent_launcher(torch, parent,
                                                        args)[0]))
    for name, make in kinds:
        lf = make()
        ev, host_ms = cs.time_launches([lf], 200, warmup=10)
        prof = cs.profile_kernels([lf], [NAME], n=50)[NAME]
        g = cs.graph_ms(torch, make)
        print(json.dumps({"shape": DECODE, "variant": name,
                          "plan": launch.plan._asdict() if name == "shipped"
                          else None,
                          "max_abs_err_vs_plain": err, "events_ms": ev,
                          "host_ms": host_ms, "graph_ms": g,
                          "profiler_ms": prof, "bound_ms": bound,
                          "share_of_bound_events": bound / ev,
                          "share_of_bound_graph": bound / g,
                          "share_of_bound_profiler":
                              bound / prof if prof else None}), flush=True)
    print(json.dumps({"shape": DECODE, "host_us_a_call": host}), flush=True)


if __name__ == "__main__":
    main()
