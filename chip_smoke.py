#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line:

1. Build the CUDA kernels from the checkout's sources with ``nvcc`` into
   ``build/repro_torch_kernels/`` (all sources at once) and print the
   build time, ptxas' register/shared-memory report and the card.
2. Hold each kernel bit for bit against its plain torch version on the
   card: ``sched_pop`` at Q=2048, B=64, C=4 and ``fused_round`` at the
   default engine widths, on adversarial inputs.
3. Drive the fused main path (``StreamEngine.round``) at the default
   ``EngineConfig`` widths with 4,096 streams for 64 rounds, once through
   the kernels and once through their plain versions; every state leaf,
   stat and sink must agree bitwise, and ``fused_round`` must have
   launched once per round.
4. The same registry plus one ``tanh`` composite flips the engine to the
   staged path; same comparison, and ``sched_pop`` must have launched
   once per round.
5. Time each kernel at the phase-3 shapes (CUDA events around many
   back-to-back launches with the host preparation done beforehand, and
   ``torch.profiler``'s device time per CUDA kernel) beside its plain
   version, and work out its bound from the bytes this run's data needs
   and from the dependent chain of its selection steps (the card's cycles
   per dependent instruction measured here by a one-thread probe).

The last three lines are the card (``nvidia-smi``), a JSON object with
one entry per kernel, and ``{"ok": true, "device": {...}}``.  Any
mismatch, build failure or launch error exits non-zero before them.
Without CUDA, or without ``src/repro_torch`` beside this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the float32 rate
# outside the tensor cores, used for the scalar integer/float work here.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SEED = 20240611

# One thread runs a chain of dependent integer min/xor instructions and
# reads the SM cycle counter around it: the card's cycles per dependent
# instruction, the unit of the selection chain's bound.
PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void dep_chain(int n, int a, int b, long long* cycles, int* out) {
  int x = a;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      asm volatile("min.s32 %0, %0, %1;" : "+r"(x) : "r"(b));
      asm volatile("xor.b32 %0, %0, %1;" : "+r"(x) : "r"(a));
    }
  }
  const long long t1 = clock64();
  *cycles = t1 - t0;
  *out = x;
}
extern "C" int dep_chain_run(int n, int a, int b, void* cycles, void* out) {
  dep_chain<<<1, 1>>>(n, a, b, (long long*)cycles, (int*)out);
  return (int)cudaDeviceSynchronize();
}
"""
PROBE_STEPS = 4096          # outer iterations; 64 dependent instructions each


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


# --------------------------------------------------------------------------
# comparisons and timing
# --------------------------------------------------------------------------

def bits(x):
    """A tensor as host numpy with float32 viewed as int32 (so -0.0 and
    NaN payloads compare by their bits)."""
    a = x.detach().cpu().numpy()
    return a.view("int32") if a.dtype.name == "float32" else a


def compare(name, got, want) -> float:
    """Fail unless ``got`` and ``want`` (nested tuples of tensors) are
    bitwise equal; return the max absolute difference (0.0)."""
    import numpy as np
    if isinstance(want, (tuple, list)):
        errs = [compare(f"{name}[{i}]", g, w)
                for i, (g, w) in enumerate(zip(got, want))]
        return max(errs) if errs else 0.0
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
             f"{tuple(want.shape)}/{want.dtype}")
    a, b = bits(got), bits(want)
    if not np.array_equal(a, b):
        n = int((a != b).sum())
        fail(f"{name}: {n} of {a.size} elements differ from the plain version")
    return 0.0


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of one ``fn()`` call on the card (one CUDA
    event pair per call, after ``warmup`` untimed calls): for the plain
    versions, whose host work is part of what they cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def time_launches(launches, n: int, warmup: int = 10):
    """The kernels' own time: call every function of ``launches`` (each
    enqueues one CUDA kernel and does no other host work) in order, ``n``
    times back to back between one CUDA event pair.  Returns (device ms
    per round of launches, host enqueue ms per round); while the second is
    below the first the card never waits for the host, so the first is
    device time.  The inputs stay in the 50 MB L2 between launches, as
    they are in the engine round, whose earlier kernels write them."""
    import torch
    for _ in range(warmup):
        for f in launches:
            f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        for f in launches:
            f()
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end) / n, host * 1e3 / n


def profile_kernels(launches, names, n: int = 50):
    """Device ms per call of each CUDA kernel whose name contains one of
    ``names``, from ``torch.profiler`` over ``n`` rounds of ``launches``;
    None for a kernel the profiler did not see."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            for f in launches:
                f()
        torch.cuda.synchronize()
    total = {k: 0.0 for k in names}
    seen = set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in names:
            if k in e.name:
                total[k] += e.time_range.elapsed_us()
                seen.add(k)
    return {k: (total[k] / n / 1e3 if k in seen else None) for k in names}


def bound_ms(n_bytes: float, n_ops: float, chain_ms: float):
    """The least time of a function: its bytes over the HBM rate, or its
    operations — the larger of their count over the scalar peak and their
    longest dependent chain (``chain_ms``) — whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / SCALAR_OPS_PER_S * 1e3, chain_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def start_probe_build():
    """Start ``nvcc`` on the dependent-chain probe (beside the kernels'
    build, in the same ignored build directory); returns (process, lib)."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "dep_chain_probe.cu"
    lib = _build.BUILD_DIR / "dep_chain_probe.so"
    src.write_text(PROBE_CU)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def run_probe(torch, proc, lib) -> float:
    """SM cycles per dependent integer instruction on this card (the
    probe's median of five runs)."""
    import ctypes
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed on the probe:\n{log}")
    fn = ctypes.CDLL(str(lib)).dep_chain_run
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    per = []
    for _ in range(5):
        err = fn(PROBE_STEPS, 0x2545F491, 0x7FFFFFF0,
                 ctypes.c_void_p(cycles.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()))
        if err != 0:
            fail(f"probe: CUDA error {err}")
        per.append(int(cycles.item()) / (PROBE_STEPS * 64))
    per.sort()
    if not per[2] >= 1.0:
        fail(f"probe: {per[2]} cycles per dependent instruction")
    return per[2]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def queue_case(rng, Q, C, T, n_sid):
    """Adversarial queue planes: ties, INT_MAX and negative priorities,
    seq collisions, weights 0 / 1 / FAIR_SCALE, NaN and -0.0 payloads."""
    import numpy as np
    prio = rng.choice([0, 0, 1, 3, -2, 2**31 - 1], Q).astype(np.int32)
    seq = rng.integers(-5, Q // 4, Q).astype(np.int32)       # collisions
    valid = rng.random(Q) < 0.7
    tenant = rng.integers(0, T, Q).astype(np.int32)
    w_slot = rng.choice([0, 1, 2, 7, 1 << 15], T).astype(np.int32)[tenant]
    sid = rng.integers(0, n_sid + 8, Q).astype(np.int32)    # some past N
    ts = rng.integers(-50, 50, Q).astype(np.int32)
    vals = rng.standard_normal((Q, C)).astype(np.float32)
    vals.ravel()[rng.integers(0, Q * C, 12)] = np.nan
    vals.ravel()[rng.integers(0, Q * C, 12)] = -0.0
    vals.ravel()[rng.integers(0, Q * C, 4)] = np.inf
    return prio, seq, valid, tenant, w_slot, sid, ts, vals


def phase_kernels(torch, dev, cfg_defaults):
    import numpy as np
    from repro_torch.kernels.round_fuse import ref as rf_ref
    from repro_torch.kernels.round_fuse.kernel import fused_round_call
    from repro_torch.kernels.round_fuse.ops import fused_stages
    from repro_torch.kernels.sched_pop.kernel import sched_pop_call
    from repro_torch.kernels.sched_pop.ops import sched_pop

    rng = np.random.default_rng(SEED)
    errs = {}
    T = cfg_defaults.n_tenants
    # -- sched_pop at Q=2048, B=64, C=4 (three cases: general, one weight-1
    # tenant with the largest tags, every slot valid with equal keys)
    Q, B, C = cfg_defaults.queue, cfg_defaults.batch, cfg_defaults.channels
    err = 0.0
    for case in range(3):
        p = list(queue_case(rng, Q, C, T, cfg_defaults.n_streams))
        if case == 1:
            p[4] = np.ones(Q, np.int32)                  # weight 1 everywhere
        if case == 2:
            p[0] = np.zeros(Q, np.int32)
            p[1] = np.zeros(Q, np.int32)
            p[2] = np.ones(Q, bool)
        args = [torch.from_numpy(a).to(dev) for a in p]
        prio, seq, valid, tenant, w_slot, sid, ts, vals = args
        got = sched_pop_call(prio, seq, valid, tenant, w_slot, sid, vals, ts, B)
        want = sched_pop(prio, seq, valid, tenant, w_slot, sid, vals, ts, B,
                         use_kernel=False)
        torch.cuda.synchronize()
        err = max(err, compare(f"sched_pop case {case}", got, want))
    errs["sched_pop"] = err
    print(f"[kernels] sched_pop Q={Q} B={B} C={C}: bitwise equal to the "
          f"plain version (3 cases)", flush=True)

    # -- fused_round at the default widths, N = 4096
    cfg = cfg_defaults
    N, F, M, L, K = cfg.n_streams, cfg.max_out, cfg.max_in, cfg.prog_len, \
        cfg.n_consts
    layout = rf_ref.RegLayout.from_cfg(cfg)
    R = layout.n_regs
    err = 0.0
    for case in range(2):
        prio, seq, valid, tenant, w_slot, sid, ts, vals = queue_case(
            rng, Q, C, T, N)
        out_table = rng.integers(-1, N, (N, F)).astype(np.int32)
        in_table = rng.integers(-2, N, (N, M)).astype(np.int32)
        ops_pool = np.asarray(sorted(rf_ref.FUSABLE_OPS), np.int32)
        progs = np.stack([rng.choice(ops_pool, (N, L)),
                          rng.integers(-3, R + 6, (N, L)),    # over-range
                          rng.integers(-3, R + 6, (N, L)),
                          rng.integers(-3, R + 6, (N, L))],
                         axis=-1).astype(np.int32)
        progs[:, L // 2:, 0] = np.where(rng.random((N, L - L // 2)) < 0.5,
                                        0, progs[:, L // 2:, 0])
        consts = rng.standard_normal((N, K)).astype(np.float32)
        is_comp = rng.random(N) < 0.75
        active = rng.random(N) < 0.9                           # revoked rows
        values = rng.standard_normal((N, C)).astype(np.float32)
        values.ravel()[rng.integers(0, N * C, 16)] = np.nan
        values.ravel()[rng.integers(0, N * C, 16)] = -0.0
        values.ravel()[rng.integers(0, N * C, 8)] = 1e-40      # subnormal
        timestamps = rng.integers(-5, 40, N).astype(np.int32)
        a = [torch.from_numpy(x).to(dev) for x in (
            prio, seq, valid, tenant, w_slot, sid, vals, ts)]
        tbl = [torch.from_numpy(x).to(dev) for x in (
            out_table, in_table, progs, consts, is_comp, active, values,
            timestamps)]
        got = fused_round_call(*a, B, *tbl, layout)
        want = fused_stages(*a, B, *tbl, layout, use_kernel=False)
        torch.cuda.synchronize()
        err = max(err, compare(f"fused_round case {case}", got, want))
    errs["fused_round"] = err
    print(f"[kernels] fused_round Q={Q} N={N} B={B} F={F} M={M} L={L} "
          f"R={R}: bitwise equal to the plain version (2 cases)", flush=True)
    return errs


# --------------------------------------------------------------------------
# phases 3-4: the main path at full width
# --------------------------------------------------------------------------

CHANNELS = ["a", "b", "c", "d"]


def build_registry(cfg, rng, streams_per_tenant=255, source_share=0.25):
    """Table I-style medium topology at full width: per tenant a quarter
    sources (4 channels), the rest composites whose in-degree is geometric
    (mean ~3.5, capped at max_in) over earlier streams of any tenant,
    out-degree capped at max_out.  Composites run multi-term fusable
    transforms; some carry pre- or post-filters."""
    from repro_torch.core import Registry
    reg = Registry(cfg)
    tenants = [reg.create_tenant(f"t{i}") for i in range(cfg.n_tenants)]
    n_src = int(streams_per_tenant * source_share)
    streams, out_deg = [], []
    for t in tenants:
        for i in range(n_src):
            streams.append(reg.create_stream(t, f"{t.name}s{i}", CHANNELS))
            out_deg.append(0)
    n_sources = len(streams)
    for i in range(streams_per_tenant - n_src):
        for t in tenants:
            k = min(int(rng.geometric(1 / 3.5)), cfg.max_in)
            open_ = [j for j in range(len(streams)) if out_deg[j] < cfg.max_out]
            picks = rng.choice(open_, size=min(k, len(open_)), replace=False)
            for j in picks:
                out_deg[j] += 1
            ins = [streams[j] for j in picks]
            transform = {}
            for c, ch in enumerate(CHANNELS):
                terms = [f"in{m}.{CHANNELS[(c + m) % 4]}"
                         for m in range(min(len(ins), 3))]
                e = f"{terms[0]} * 0.5"
                if len(terms) > 1:
                    e += f" + {terms[1]}"
                e += (f" - max({terms[2]}, 0.0)" if len(terms) > 2
                      else f" + prev.{ch} * 0.25")
                transform[ch] = e
            kind = int(rng.integers(0, 3))
            s = reg.create_composite(
                t, f"{t.name}c{i}", CHANNELS, ins, transform,
                pre_filter="abs(in0.a) < 3.0" if kind == 1 else None,
                post_filter="out.a < 1000" if kind == 2 else None)
            streams.append(s)
            out_deg.append(0)
    return reg, streams[:n_sources]


def drive(torch, eng, sources, rounds, seed, per_round, warmup=0):
    """Post ``per_round`` SUs to distinct random sources and run one
    round, ``rounds`` times.  Returns the sinks of every round and the
    wall seconds of the rounds after the first ``warmup``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sinks = []
    for r in range(rounds):
        if r == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for j in rng.choice(len(sources), per_round, replace=False):
            eng.post(sources[j], rng.standard_normal(4).tolist(),
                     r * 10 + int(rng.integers(0, 9)))
        sinks.append(eng.round())
    torch.cuda.synchronize()
    return sinks, time.perf_counter() - t0


def plain_engine(reg, dev):
    """An engine on the card whose round closures run the kernels' plain
    torch versions: the history the kernels are held against."""
    from repro_torch.core import create_engine
    from repro_torch.core.engine import make_step
    eng = create_engine(reg, device=dev)
    eng._steps = {p: make_step(reg.cfg, fused=p == "fused", use_kernel=False)
                  for p in ("fused", "staged")}
    eng._select_path()
    return eng


def compare_engines(tag, e_kernel, s_kernel, e_plain, s_plain):
    st_k, st_p = e_kernel.state, e_plain.state
    for f in st_k._fields:
        if f == "stats":
            for k in st_k.stats:
                compare(f"{tag} stats/{k}", st_k.stats[k], st_p.stats[k])
        else:
            compare(f"{tag} state/{f}", getattr(st_k, f), getattr(st_p, f))
    for i, (a, b) in enumerate(zip(s_kernel, s_plain)):
        compare(f"{tag} sink{i}", tuple(a), tuple(b))


def phase_path(torch, dev, reg, sources, path, rounds, warmup, counter,
               counters):
    """Drive one round path through the kernels and through the plain
    versions; every launch counter is 0 just before the kernel run, and
    ``counter`` (the path's kernel) must read one launch per round.  All
    ``rounds`` are compared; the wall time is that of the rounds after
    the first ``warmup`` (steady state)."""
    from repro_torch.core import create_engine
    e_plain = plain_engine(reg, dev)
    e_kernel = create_engine(reg, device=dev)
    for e in (e_plain, e_kernel):
        if e._path != path:
            fail(f"expected the {path} path, engine took {e._path}")
    s_plain, _ = drive(torch, e_plain, sources, rounds, SEED + 1,
                       reg.cfg.batch)
    for c in counters:
        c.launches = 0
    s_kernel, secs = drive(torch, e_kernel, sources, rounds, SEED + 1,
                           reg.cfg.batch, warmup)
    launches = counter.launches
    counts = ", ".join(f"{c.__name__}={c.launches}" for c in counters)
    if launches != rounds:
        fail(f"{path} path: {counter.__name__} launched {launches} times in "
             f"{rounds} rounds")
    compare_engines(path, e_kernel, s_kernel, e_plain, s_plain)
    c = e_kernel.counters()
    if c["emitted"] == 0 or c["processed"] == 0:
        fail(f"{path} path: the run emitted nothing")
    timed = rounds - warmup
    print(f"[{path}] {rounds} rounds, {reg.n_active} streams: bitwise equal "
          f"to the plain path; launches {counts}; rounds {warmup + 1}-"
          f"{rounds}: {timed / secs} rounds/s, {secs / timed * 1e3} "
          f"ms/round; processed={c['processed']} emitted={c['emitted']} "
          f"queued_in={c['queued_in']} "
          f"dropped_overflow={c['dropped_overflow']} "
          f"queue occupancy={int(e_kernel.state.q_valid.sum())}", flush=True)
    return e_kernel, launches, secs


# --------------------------------------------------------------------------
# phase 5: timings at the phase-3 shapes
# --------------------------------------------------------------------------

def pop_bytes(Q: int, B: int, C: int) -> int:
    """Bytes the pop must move: per slot the priority, seq, tenant and
    weight int32 planes and the valid byte; the B winners' sid, ts and
    payload; and its outputs (take, sid, ts, valid, payload)."""
    return Q * (4 * 4 + 1) + B * (4 + 4 + 4 * C) + B * (3 * 4 + 1 + 4 * C)


def fused_round_bytes(torch, cfg, tb, out) -> int:
    """Bytes the fused round must move on this run's data: the pop's, the
    out_table rows and active flags of the winners' streams, and for every
    distinct stream row a work item lands on (an invalid item computes on
    row 0, as the kernel and its plain version do) its in_table row,
    is_composite flag, previous value and timestamp, program up to its
    last non-NOP instruction and the constants its CONST instructions
    read; the value and timestamp of every co-input row an item fetches
    (its trigger slot comes with the event); and every output once."""
    from repro_torch.core.program import OP_CONST
    take, (e_sid, _, _, _, _), wi_t, _ = out
    N, F, M = cfg.n_streams, cfg.max_out, cfg.max_in
    B, C, K, L = cfg.batch, cfg.channels, cfg.n_consts, cfg.prog_len
    W = B * F
    dev = wi_t.device
    n = pop_bytes(cfg.queue, B, C) - B * (3 * 4 + 1 + 4 * C)
    win = torch.clamp(e_sid, 0, N - 1).long().unique()
    items = torch.clamp(wi_t, 0, N - 1).long()
    rows = items.unique()
    n += win.numel() * F * 4
    n += torch.cat([win, rows]).unique().numel()
    n += rows.numel() * (M * 4 + 1 + 4 * C + 4)
    progs = tb.progs[rows]
    steps = torch.arange(1, L + 1, device=dev)
    l_eff = torch.where(progs[..., 0] != 0, steps, 0).max(dim=1).values
    n += 16 * int(l_eff.sum())
    a = progs[..., 2]
    a = torch.clamp(torch.where(a < 0, a + K, a), 0, K - 1)
    const = (progs[..., 0] == OP_CONST) & (steps[None, :] <= l_eff[:, None])
    n += 4 * (rows[:, None] * K + a)[const].unique().numel()
    in_rows = tb.in_table[items]
    src = torch.repeat_interleave(e_sid, F)
    hit = (in_rows >= 0) & (in_rows == src[:, None])
    trig = torch.where(hit.any(dim=1), hit.int().argmax(dim=1), 0)
    fetch = (in_rows >= 0) & (
        torch.arange(M, device=dev)[None, :] != trig[:, None])
    n += torch.clamp(in_rows[fetch], 0, N - 1).unique().numel() * (4 * C + 4)
    n += B * (3 * 4 + 2 + 4 * C) + W * 4 + W * (4 * C + 4 + 5)
    return n


def phase_timings(torch, eng, errs, launches, dep_cycles, clock_hz):
    import math
    from repro_torch.core import engine as E
    from repro_torch.kernels.round_fuse import ref as rf_ref
    from repro_torch.kernels.round_fuse.kernel import plan_fused_round
    from repro_torch.kernels.round_fuse.ops import fused_stages
    from repro_torch.kernels.sched_pop.kernel import plan_sched_pop
    from repro_torch.kernels.sched_pop.ops import sched_pop

    cfg, tb, st = eng.cfg, eng.tables, eng.state
    T, B, F = cfg.n_tenants, cfg.batch, cfg.max_out
    Q, C = cfg.queue, cfg.channels
    prio = E._take(tb.priority, st.q_sid)
    t_slot = torch.clamp(E._take(tb.tenant, st.q_sid), 0, T - 1)
    w_slot = tb.weight[t_slot.long()]
    q = (prio, st.q_seq, st.q_valid, t_slot, w_slot, st.q_sid, st.q_vals,
         st.q_ts)
    layout = rf_ref.RegLayout.from_cfg(cfg)
    eff = tb.active & ~st.quarantined
    tbl = (tb.out_table, tb.in_table, tb.progs, tb.consts, tb.is_composite,
           eff, st.values, st.timestamps)
    out = fused_stages(*q, B, *tbl, layout, use_kernel=False)
    n_valid = int((out[2] >= 0).sum())
    n_queued = int(st.q_valid.sum())

    # both kernels run B dependent selection steps, each a minimum over Q
    # candidates (a compare tree of ceil(log2 Q) levels) and then the tag
    # bump the next step reads: at least that many dependent instructions
    levels = B * (math.ceil(math.log2(Q)) + 1)
    chain = levels * dep_cycles / clock_hz * 1e3
    print(f"[bound] selection chain: {levels} dependent instructions x "
          f"{dep_cycles} cycles (probe) at the {clock_hz / 1e6} MHz maximum "
          f"SM clock = {chain} ms", flush=True)

    rows_out = []
    sp_bytes = pop_bytes(Q, B, C)
    sp_bound, sp_by = bound_ms(sp_bytes, B * Q, chain)
    sp_launch, _ = plan_sched_pop(*q, B)
    sp_ms, sp_host = time_launches([sp_launch], 200)
    sp_prof = profile_kernels([sp_launch], ["sched_pop_kernel"])
    sp_plain = time_ms(lambda: sched_pop(*q, B, use_kernel=False), reps=10)
    lex_ms = time_ms(lambda: E._pop(st, tb.priority, B, tb.tenant,
                                    tb.weight, "lexsort"), reps=20)
    rows_out.append(dict(
        name="sched_pop", route="cuda",
        source="src/repro_torch/kernels/sched_pop/csrc/sched_pop.cu",
        replaces="src/repro/kernels/sched_pop/kernel.py:103",
        launches=launches["sched_pop"], max_abs_err=errs["sched_pop"],
        ms=sp_ms, plain_ms=sp_plain, bound_ms=sp_bound, bound_by=sp_by,
        library_ms=None))
    print(f"[timing] sched_pop: kernel {sp_ms} ms (CUDA events over 200 "
          f"back-to-back launches; host enqueue {sp_host} ms per launch), "
          f"profiler {sp_prof['sched_pop_kernel']} ms; plain {sp_plain} ms; "
          f"lexsort pop {lex_ms} ms (context); bound {sp_bound} ms "
          f"({sp_by}; {sp_bytes} bytes); queue occupancy {n_queued}/{Q}",
          flush=True)

    fr_bytes = fused_round_bytes(torch, cfg, tb, out)
    fr_bound, fr_by = bound_ms(fr_bytes, B * Q, chain)
    (pop_l, apply_l), _ = plan_fused_round(*q, B, *tbl, layout)
    fr_ms, fr_host = time_launches([pop_l, apply_l], 200)
    pop_ms, pop_host = time_launches([pop_l], 200)
    fr_prof = profile_kernels([pop_l, apply_l], ["pop_dispatch_kernel",
                                                 "apply_programs_kernel"])
    fr_plain = time_ms(lambda: fused_stages(*q, B, *tbl, layout,
                                            use_kernel=False), reps=5)
    rows_out.append(dict(
        name="fused_round", route="cuda",
        source="src/repro_torch/kernels/round_fuse/csrc/fused_round.cu",
        replaces="src/repro/kernels/round_fuse/kernel.py:363",
        launches=launches["fused_round"], max_abs_err=errs["fused_round"],
        ms=fr_ms, plain_ms=fr_plain, bound_ms=fr_bound, bound_by=fr_by,
        library_ms=None))
    print(f"[timing] fused_round: kernel pair {fr_ms} ms (CUDA events over "
          f"200 back-to-back pop_dispatch + apply_programs launches; host "
          f"enqueue {fr_host} ms per pair), pop_dispatch alone {pop_ms} ms "
          f"(host {pop_host} ms); profiler pop_dispatch "
          f"{fr_prof['pop_dispatch_kernel']} ms + apply_programs "
          f"{fr_prof['apply_programs_kernel']} ms; plain {fr_plain} ms; "
          f"bound {fr_bound} ms ({fr_by}; {fr_bytes} bytes); "
          f"{n_valid}/{B * F} valid work items", flush=True)
    return rows_out


# --------------------------------------------------------------------------

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail("src/repro_torch is not beside chip_smoke.py: run it from the "
             "root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.round_fuse.kernel import fused_round_call
    from repro_torch.kernels.sched_pop.kernel import sched_pop_call

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. build -------------------------------------------------------
    probe = start_probe_build()
    _build.build_all(verbose_ptxas=True)
    print(f"[build] {len(_build.sources())} CUDA sources built with nvcc "
          f"into {_build.BUILD_DIR.relative_to(ROOT)} in "
          f"{_build.build_seconds:.2f} s", flush=True)
    for stem, log in _build.build_log.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}", flush=True)
    smi = nvidia_smi()
    clock_hz = max_sm_clock_hz()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}; maximum "
          f"SM clock {clock_hz / 1e6} MHz", flush=True)
    dep_cycles = run_probe(torch, *probe)
    print(f"[probe] {dep_cycles} SM cycles per dependent integer "
          f"instruction", flush=True)

    # ---- 2. kernels against their plain versions -----------------------
    cfg = EngineConfig(n_streams=4096).validate()
    errs = phase_kernels(torch, dev, cfg)

    # ---- 3. fused main path at full width ------------------------------
    import numpy as np
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    reg, sources = build_registry(cfg, rng)
    print(f"[registry] {reg.n_active} streams ({len(sources)} sources) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counters = (fused_round_call, sched_pop_call)
    eng, fr_launches, _ = phase_path(torch, dev, reg, sources, "fused", 64,
                                     8, fused_round_call, counters)

    # ---- 4. staged main path: one tanh composite flips it --------------
    reg.create_composite(reg.tenants[0], "hot", CHANNELS, sources[:2],
                         {ch: f"tanh(in0.{ch}) + in1.{ch}" for ch in CHANNELS})
    _, sp_launches, _ = phase_path(torch, dev, reg, sources, "staged", 24,
                                   4, sched_pop_call, counters)

    # ---- 5. timings ------------------------------------------------------
    rows = phase_timings(torch, eng, errs, {"sched_pop": sp_launches,
                                            "fused_round": fr_launches},
                         dep_cycles, clock_hz)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
