#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line:

1. Build the CUDA kernels from the checkout's sources with ``nvcc`` into
   ``build/repro_torch_kernels/`` (all sources at once) and print the
   build time, ptxas' register/shared-memory report and the card; for
   each head-dim template of the bf16 attention kernel
   (``flash_attention_wgmma_kernel``) its registers, spills and dynamic
   shared memory and the HGMMA instructions in its SASS (``cuobjdump
   -sass``; none fails the run), and the same for each kernel of
   ``mlstm_chunkwise`` (every one of its six product kernels, the state,
   intra and out kernels for float32 and for bf16 inputs, must have HGMMA
   instructions), and for each template of ``selective_scan`` (the ring
   per S; the register path per S and states a thread) its registers,
   spills and dynamic shared memory.
2. Hold each kernel bit for bit against its plain torch version on the
   card: ``sched_pop`` at Q=2048, B=64, C=4 (also at 1,024 tenants and at
   Q=2049), ``fused_round`` at the
   default engine widths (random programs, programs whose last
   instruction is not a NOP, all-NOP programs, and 32 different opcodes
   across every warp at each pc, on the apply's per-event planes of
   rep = F items), ``window_agg`` at W in {1, 5, 8, 33, 256, 1024}
   and C in {1, 3, 4, 5} (and C = 40, a stream over two warps) with N a
   multiple of no warp's stream count, on both staging paths (bulk
   copies where W C is a multiple of 4, 4-byte per-lane copies where it
   is not and on a view one float into its buffer), counts of 0, W and
   in between,
   ``exchange_compact`` at the 4-shard smoke shape (4 senders of 1,024
   items, 4 x 1,024 slots) and at D in {1, 2, 3, 8, 32} with overflow,
   every item to one shard, unrouted lanes, W of 1 and of 5,000, slots
   no multiple of the 256-slot tile and C in {1, 3, 4},
   ``apply_programs`` at 4 shards x 4,096 items against 1,024
   table rows and a 4,096-row snapshot and at smaller odd shapes (W no
   multiple of the CTA's items; the program kinds above; C in {1, 3, 4};
   the longest program whose CTA fits the shared-memory limit, with the
   launcher's shared bytes checked against the wrapper's fit check), on
   adversarial inputs (NaN, -0.0, subnormals, empty and full windows),
   ``onehot_gather`` on the sweeps of ``tests/test_kernels.py``, the
   (4096, 16) out-table with 64 ids, the (4096, 4) value snapshot with
   4,096 ids and the (1024, 16) shard table (int32 tables over the whole
   range; float tables with -0.0, subnormals, NaN payloads and
   infinities, whose bits must pass), its by-sid snapshot
   (``by_sid_snapshot``) of 1, 2, 4 and 3 shards with ids out of range
   and the same float bits, and ``stream_dispatch`` with and
   without the early mask at the smoke shape ((4096, 16) out-table,
   B = 64), the shard shape ((1024, 16) against 4,096 timestamps) and
   odd shapes (valid events with out-of-range sids, entries below -1 and
   at or past the timestamps, INT32_MIN/MAX timestamps).  Also
   ``selective_scan`` at jamba's decode shape (B 4, L 1, Di 8,192, S 16,
   a non-zero carried state) within 1e-4, timed beside its plain version,
   with its plan and its share of the bound by events and the profiler.
3. Drive the fused main path (``StreamEngine.round``) at the default
   ``EngineConfig`` widths with 4,096 streams for 48 rounds, once through
   the kernels and once through their plain versions; every state leaf,
   stat and sink must agree bitwise, and ``fused_round`` must have
   launched once per round.
4. The same registry through six supersteps of K = 8
   (``StreamEngine.superstep``), each K rounds run under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
   between the staging copy and the spool readback), against 48 eager
   rounds on a second engine: every state leaf, stat and per-round sink
   bitwise; ms per superstep beside K x ms per eager round.
5. The same registry plus one ``tanh`` composite flips the engine to the
   staged path; phase 3's comparison over 16 rounds, and ``sched_pop``
   must have launched once per round.
6. Phase 4 on the staged path: two supersteps of K = 8 against 16 eager
   rounds.
7. The IoT suite at full width (1,024 tenants of ETL and STATS flows,
   3,586 streams, a 256-entry window store of 14.7 MB) replayed by
   ``repro_torch.workloads.drive`` through supersteps of K = 8, once
   through the kernels and once through their plain versions: engine
   state, every latency record, the SLO histograms and report, the window
   store and the five aggregates bitwise; wall time, supersteps/s and
   records/s of the kernel run.
8. The sharded fused round: phase 3's registry on 4 shards emulated on
   the card (``exchange_slots=0``: 1,024 slots per destination, 4,096
   applied items per shard), through the kernels and through their plain
   versions, with live churn every third wave (admit a composite, revoke
   an earlier one, swap a program, ``rebalance``), table storage
   unchanged; drained waves of two SUs, after each of which the 4-shard
   engine must hold the single-device engine's values, timestamps and
   counters; then 24 heavy rounds of 64 posted SUs, the last 16 timed
   (the engine ingests one batch per round across all shards; the
   warm-up builds the emission backlog that fills the shards' pops).
   ``sched_pop``, ``exchange_compact``, ``by_sid_snapshot`` (the by-sid
   snapshot of values and timestamps) and ``apply_programs`` must have
   launched 4, 1, 1 and 1 times per round.
9. Phase 4 on the 4-shard fused engine: three supersteps of K = 8 under
   the sync debug mode against 24 eager sharded rounds.
10. Phase 8 on the staged path (phase 5's registry), kernels against
    plain, 16 heavy rounds, the last 8 timed; ``exchange_compact`` and
    ``by_sid_snapshot`` must have launched once per round,
    ``apply_programs`` never.
11. The IoT suite at 128 tenants, where every round drains (16 trace
    rounds), at 4 shards against 1 shard, both through the kernels:
    latency histograms, SLO report, records, window aggregates and
    counters equal.  Then phase 7
    on 4 shards at 8 trace rounds (``SHARDED_SUITE_ROUNDS``): the
    full-width suite through the kernels and through their plain
    versions, bitwise.
12. The engine with the stream-dispatch fan-out
    (``fanout_fn=make_fanout()``) on every path that calls it: 16 staged
    single-device rounds (phase 5's registry), two staged supersteps of
    K = 8 (their rounds under the sync debug mode, and equal to 16 eager
    rounds), 16 heavy 4-shard fused rounds and 4 heavy 4-shard staged
    rounds.  On each, the engine with the kernel must equal the same
    engine with ``make_fanout(use_kernel=False)`` and with the default
    ``fanout_reference`` bitwise (every state leaf, stat, DLQ entry,
    sink and spool), and ``stream_dispatch`` must have launched once per
    round and shard.
13. Time each kernel at the main path's shapes (CUDA events around many
    back-to-back launches with the host preparation done beforehand, and
    ``torch.profiler``'s device time per CUDA kernel; the sharded
    kernels' inputs are recorded from one more heavy round of phase 8's
    engine, the dispatch kernels' from one more round of phase 12's)
    beside its plain version, and work out its bound from the bytes this
    run's data needs and from its operations (for the two pops, the
    dependent chain of two selections over the queue, one for the tags and
    one for the pick, and for the apply the longest non-NOP program among
    the items, each at the card's cycles per dependent instruction
    measured here by a one-thread probe; the terms and which binds are
    printed); for the
    dispatch kernels ``torch.index_select`` of the same rows is timed as
    the nearest library call, and an empty kernel is timed in one
    profiler window with ``exchange_compact``, the by-sid snapshot and
    ``stream_dispatch`` as their launch floor; ``window_agg`` on both
    staging paths (the aligned store and a view one float into its
    buffer) at the suite's store and at (4096, 1024, 4), beside the
    prediction written before its first timed run.

14. The model plane's two kernels against their plain versions:
    ``flash_attention`` on the sweep of ``tests/test_kernels.py`` and odd
    lengths and widths (as transposed views of (B, H, L, Dh) tensors),
    within 2e-5 in float32 and 2e-2 in bf16, and at the full-width
    layers of the model plane in the model's (B, L, H, Dh) layout
    (gemma3-1b's local and global, jamba's, gemma3-27b's local (window
    1,024) and global, and one layer each of deepseek-moe-16b, minitron-8b,
    mistral-large-123b (a GQA group of 12), musicgen-large (32 heads of
    Dh 64) and qwen2-vl-72b), within 2e-5 in float32 and one bf16 unit
    in the last place (2^-7 of |plain| + 1e-5) in bf16;
    ``selective_scan`` on its sweep, odd shapes, jamba's Mamba layer
    (B 1, L 4096, Di 8192, S 16) and rows of 2 KB (B 2, Di 8,200), then
    B 4 with a carried state at L 1, 2, T - 1, T, T + 1 and 300 (T the
    ring's steps a chunk) for every S, Di 333, and on views one float into
    their buffers, within 1e-4; the sweep must reach the ring path and
    the register path with four and with one state a thread.
15-16. ``make_prefill_step`` (``repro_torch.models``) of gemma3-1b at its
    published size (26 layers, B 2) and of jamba-v0.1-52b at full width
    and one period of 8 of its 32 layers (B 1; all 32 exceed the card's
    memory), prompts of 4,096 tokens drawn from the seed, weights from a
    seeded generator on the card, in bf16: once through the kernels (its
    launches must equal the attention and Mamba layers: 26 and 0; 1 and
    7) and once through their plain versions, the last position's logits
    and every cache leaf within 0.1 of the leaf's max |plain|; ms per
    prefill, prompt tokens/s, peak memory.  The plain pass routes each
    token to the experts the kernel pass chose (``RouteReplay``), so the
    bf16 gate reads the kernels' arithmetic and not a router flipped by
    a last-bit difference; the tokens whose own choice differed are
    counted and printed.  The bf16 comparison runs twice for each of
    three seeds (weights and prompts).  Then the first seed's weights
    upcast to float32, kernels against plain (routing not replayed)
    within 1e-4 of each leaf's max.
17. Both model kernels timed at the slice's shapes (CUDA events and the
    profiler's device time) beside their plain versions, their bounds
    (attention's operations at the bf16 tensor-core peak, the scan's
    bytes) and, for attention, ``scaled_dot_product_attention``:
    attention in bf16 at gemma3-1b's, jamba's, gemma3-27b's two,
    mistral-large-123b's and musicgen-large's full-width layers, with its
    achieved TFLOP/s on the 4 B H pairs Dh operations the function needs;
    also
    attention's float32 time at jamba's layer; the scan at jamba's
    Mamba layer with its plan (path, template, CTAs) and its share of
    the bound by events and by the profiler.
18. ``mlstm_chunkwise`` (G1) against its plain chunkwise version and the
    float64 sequential oracle, both within 3e-4 + 3e-4 |ref|
    (``tests/test_kernels.py``), on the sweep of ``tests/test_kernels.py``,
    lengths that are no multiple of the chunk, Dh up to 1,024 and forget
    gates near 0 and 1 and very negative input gates, once with float32
    and once with bf16 q, k, v (the plain version upcasts them).
19. ``make_prefill_step`` of xlstm-1.3b at full width and two of its six
    periods (``XLSTM_LAYERS`` = 16 of 48 layers: 2 sLSTM, 14 mLSTM; B 2,
    L 4,096) in bf16, weights and prompts from the seed: the counted
    prefill must launch ``mlstm_chunkwise``'s five kernels once per mLSTM
    layer (70) and nothing else; per leaf, kernels (in bf16 the counted
    prefill) against plain beside the plain version against itself with
    the token embeddings one ulp up, in bf16 and in float32 (gated only
    on finite values: the whole model amplifies a last-bit difference far
    past 1e-4); bf16 prefills timed (1 each, after earlier runs), prompt
    tokens/s, peak memory, and one more prefill with each sLSTM scan
    timed.  G2: every layer fed the plain run's input, its
    output and cache leaves within 0.1 (bf16) and 1e-4 (float32) of the
    leaf's max |plain|.  G1 at full width on the inputs the float32 plain
    run feeds its first and its last mLSTM layer (3e-4, with each path's
    distance from the float64 oracle printed).
20. G3: the first period (8 layers, B 2, L 4,096) in float64 through the
    plain versions is the truth; per leaf, the float32 prefill through
    the kernels must stray from it at most 10 x the plain float32
    prefill's distance + 1e-6.
21. ``mlstm_chunkwise`` timed at the slice's shape on the float32 run's
    last mLSTM inputs, and on the same with q, k, v in bf16, each of its
    five kernels alone too, beside its plain version and its bound (the
    operations at the bf16 tensor-core peak, or the bytes), with the
    tensor work of its piece products (phase 19 also times the three plain
    sLSTM scans inside one bf16 prefill).

22. Kill and resume at the smoke cell's width with retention rings of 16
    and a dead-letter spool of 512 (``copy_registry(...,
    retention_slots=16, dlq_slots=512)``), at 1 shard fused, 1 shard
    staged (phase 5's ``tanh`` composite) and 4 shards fused: an engine
    checkpointing every second superstep of K = 4 asynchronously
    (``checkpoint_to``) is deleted after four supersteps and rebuilt by
    ``restore_engine`` from the directory; it must equal an engine that
    ran the same input without interruption and a plain-version engine,
    at the resume point and after one round and one superstep more
    (every snapshot array: tables, state, stats, retention rings, dead
    letters, backlog; every sink).  A truncated leaf of the newest
    checkpoint must make ``load`` raise ``CheckpointCorrupt`` and
    ``restore_engine`` fall back to the one before.  Times on the host
    clock with the card synchronised: ``snapshot()`` and its bytes,
    ``save_sync``, the blocking part of ``save_async``, ``restore_engine``
    from disk, and the first round after the restore.
23. Replay and redelivery at 1 and 4 shards, kernels against plain
    bitwise after each step: a late joiner admitted with ``replay=True``,
    quota-shed SUs drained and redelivered, a revoked stream's purged
    queue redelivered (refused, spooled again and counted in
    ``redeliver_rejected``), and the rounds after each.
24. The resize chain 1 -> 2 -> 4 -> 2 -> 1 (supersteps of K = 4) with a
    loaded queue at each hop: each resize equal to ``restore_engine(snapshot, n_shards=M)``
    and to the plain-version engine resized alike, also after a superstep
    more, the kernels launched at each shard count (``exchange_compact``
    and ``apply_programs`` at D = 2); ms per resize.  Then an
    ``Autoscaler(min_shards=1, max_shards=4)`` on a burst and an idle
    drain, through the kernels and through the plain versions: a
    scale-up and a scale-down, the same events, the same final engine.
25. The chaos drill (``repro_torch.launch``) at 1 shard fused and at 4
    shards fused with ``fanout_fn=make_fanout()``: the cell of phase 22
    with the breaker armed and an island of four streams of tenant 0
    that nothing else reads.  A ``Supervisor`` drives a kernel engine
    through six supersteps of K = 4 under a seeded ``ChaosMonkey``:
    poisoned payloads on the island's sources, a storm, a hostile
    overflow swap, a torn newest checkpoint with a ``ShardKill``, and a
    second kill.  It must recover both, restore on the card with its
    fan-out and kernel choice, launch the round kernels once per round
    of every superstep it ran (replays included), and equal an
    undisturbed twin (every snapshot array; every sink of one superstep
    more), which must equal its plain-version engine; the breaker alone
    quarantines the island's composites; co-tenant emissions equal a
    clean engine's (deficit 0).  Each incident's ``downtime_s`` (MTTR)
    and the synchronised time of the step that recovered are printed
    beside phase 22's ``restore_engine`` times.

26. ``make_decode_step`` at full width: gemma3-1b (26 layers, B 4, L
    1,536, so the local layers' 512-slot rings wrap), and the first
    period (8 layers) of jamba-v0.1-52b (B 2, L 512: its MoE groups
    min(512, L) tokens, which must divide L and L - 1) and of
    xlstm-1.3b (B 4, L 1,536).  ``make_prefill_step(pad_to=L)`` on
    L - 1 tokens and one decode step of the last equal the last logits
    of a prefill of all L tokens: within 1e-4 of the max in float32 and
    0.1 in bf16 (jamba only in float32, its MoE capacity raised to hold
    every token: a decode token is never dropped, a prefill token can
    be).  jamba's bf16 decode through the kernels against the plain
    versions (the plain pass on the kernel pass's experts,
    ``RouteReplay``), every returned leaf within 0.1.  The counted decode
    step launches ``selective_scan_call`` once per Mamba layer and no
    other kernel.
27. The continuous batcher on gemma3-1b at its published size, 4 slots,
    8 requests (each slot serves twice): in float32 its tokens equal
    greedy decoding through ``forward`` (the reference's smallest top-2
    logit gap above 1e-4); in bf16 timed: ms per tick, tokens/s, CUDA
    kernels and host synchronisations per tick, KV-cache bytes and the
    tick's memory bound.  Then ``repro_torch.launch.serve.main`` once at
    full width.
28. PRED flows through the serving bridge: ``build_suite`` with ETL,
    STATS and PRED tenants in turn (24 tenants, 8 trace rounds and 4
    more, supersteps of K = 4), ``wire_pred`` with a bf16 gemma3-1b
    batcher (4 slots), at 1 shard and at 4 shards, fused; the engine
    through the kernels against the engine through their plain versions,
    each with its own batcher on the same weights, the model under
    ``torch.use_deterministic_algorithms(True)`` (``main`` sets
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts, as that mode needs):
    engine state, SLO histograms and report,
    window store, the bridge's completions and the response streams
    bitwise, the round kernels once per round.  PRED latency p50/p95/p99
    (rounds), requests, ticks and ``drive()`` wall time are printed.
29. The seven other architectures at their published widths, one
    ``[time]`` stamp each: gemma3-27b, deepseek-moe-16b, qwen2-moe-a2.7b,
    minitron-8b and musicgen-large at their published depths,
    mistral-large-123b at 16 of 88 layers and qwen2-vl-72b at 24 of 80
    (all layers exceed the card's memory).  For each: (a) the bf16
    prefill (B 1, L 4,096 token ids, musicgen's four codebook ids a
    position or qwen2-vl's input embeddings; weights drawn on the card
    from the seed leaf by leaf, cast as drawn) through the kernels, its
    ``flash_attention_call`` launches equal to the attention layers and
    no other kernel launched, timed once more, then through the plain
    versions on the kernel pass's experts, logits and every cache leaf
    within 0.1 of the leaf's max |plain|; (b) a float32 copy cut to the
    prefix layers and the first period (two layers where the period is
    one), drawn in float32 from the same seed, kernels against plain
    within 1e-4; (c) prefill(L - 1) + one decode step against the prefill
    of all L positions' last logits (B 2; L 1,536 for gemma3-27b, whose
    1,024-slot local rings wrap, 512 for the MoE models, whose dispatch
    groups must divide L and L - 1, else 1,024), the MoE capacity raised
    to hold every token, within 0.1 in bf16 at the run depth and 1e-4 in
    float32 on the cut copy, the counted decode step launching no kernel.
    For the five text models: the continuous batcher in float32 on the
    cut copy equals greedy decoding through ``forward`` (the reference's
    smallest top-2 gap above 1e-4 first), one bf16 run at the run depth
    timed (ms per tick, tokens/s), and ``launch.serve.main`` at the
    published size where it fits the card (all but mistral-large-123b);
    ``launch.serve.main`` must refuse musicgen-large and qwen2-vl-72b.

The last three lines are the card (``nvidia-smi``), a JSON object with
one entry per kernel, and ``{"ok": true, "device": {...}}``.  Any
mismatch, build failure or launch error exits non-zero before them.
Without CUDA, or without ``src/repro_torch`` beside this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import re
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
# instruction, the unit of the pops' selection chain and the apply's VM
# chain bounds.
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
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
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
    ``names``, from ``torch.profiler`` over ``n`` rounds of ``launches``:
    the mean over the kernel events the trace kept (it can drop some of a
    short window's, so the sum over ``n`` would read low); None for a
    kernel the profiler did not see."""
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
    count = {k: 0 for k in names}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in names:
            if k in e.name:
                total[k] += e.time_range.elapsed_us()
                count[k] += 1
    return {k: (total[k] / count[k] / 1e3 if count[k] else None)
            for k in names}


def bound_ms(n_bytes: float, n_ops: float, chain_ms: float):
    """The least time of a function: its bytes over the HBM rate, or its
    operations — the larger of their count over the scalar peak and their
    longest dependent chain (``chain_ms``) — whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / SCALAR_OPS_PER_S * 1e3, chain_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def start_probe_build():
    """Start ``nvcc`` on the dependent-chain probe and the launch-floor
    kernel (beside the kernels' build, in the same ignored build
    directory); returns (process, lib)."""
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


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    import shutil
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia"
                         / "bin" / "cuobjdump"))
    except ImportError:
        pass
    for cand in cands:
        if cand and Path(cand).exists():
            return cand
    fail("cuobjdump not found (neither the CUDA toolkit's nor Triton's)")


WGMMA_KERNEL = re.compile(r"flash_attention_wgmma_kernelILi(\d+)E")
# the mLSTM kernels, <f32> / <bf16> for the templates on the input type
MLSTM_KERNEL = re.compile(r"(mlstm_[a-z]+_kernel)(?:ILb([01])E)?")
MLSTM_PRODUCTS = ("mlstm_state_kernel", "mlstm_intra_kernel",
                  "mlstm_out_kernel")


def ptxas_sass_report(stem, lib, key_of) -> dict:
    """Per kernel of ``csrc/<stem>.cu`` that ``key_of`` (mangled name ->
    key or None) names: ptxas's registers, stack and spills (its ``-Xptxas
    -v`` log) and the HGMMA (wgmma) instructions in its SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    report, cur = {}, None
    for line in _build.build_log.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            cur = key_of(line)
            if cur:
                report.setdefault(cur, {})
        elif cur and "spill stores" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", line))
            report[cur].update(stack_bytes=stack, spill_stores=stores,
                               spill_loads=loads)
        elif cur and "Used" in line:
            report[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {lib} failed: {sass.stderr.strip()}")
    for body in re.split(r"\n\s+Function : ", sass.stdout)[1:]:
        key = key_of(body.split("\n", 1)[0])
        if key:
            report.setdefault(key, {})["hgmma"] = body.count("HGMMA")
    return report


SCAN_KERNEL = re.compile(
    r"selective_scan_(ring|register)_kernelILi(\d+)E(?:Li(\d+)E)?")


def scan_build_report(lib) -> dict:
    """Phase 1 for ``selective_scan``: each template (the ring per S, four
    states a thread; the register path per S and states a thread) with
    ptxas's registers, stack and spills and a CTA's dynamic shared bytes
    (the ring's at both row widths its plan takes).  Fails unless every
    template the plan can choose is in the build."""
    from repro_torch.kernels.selective_scan.kernel import (
        RING_FLOATS, STATES, ring_smem_bytes)

    def key_of(text):
        m = SCAN_KERNEL.search(text)
        if not m:
            return None
        return (f"ring<S {m.group(2)}, 4 states>" if m.group(1) == "ring"
                else f"register<S {m.group(2)}, {m.group(3)} states>")

    report = ptxas_sass_report("selective_scan", lib, key_of)
    want = {f"ring<S {S}, 4 states>" for S in STATES if S >= 4} | \
        {f"register<S {S}, {v} states>" for S in STATES for v in (1, 4)
         if v <= S and (v == 1 or S >= 4)}
    if not want <= set(report):
        fail(f"selective_scan: templates {sorted(want - set(report))} "
             f"missing from the build; got {sorted(report)}")
    for key, r in sorted(report.items()):
        S = int(re.search(r"S (\d+)", key).group(1))
        r["smem_bytes"] = ({RING_FLOATS // S: ring_smem_bytes(S, RING_FLOATS // S),
                            RING_FLOATS // S // 2:
                                ring_smem_bytes(S, RING_FLOATS // S // 2)}
                           if key.startswith("ring") else 0)
        smem = (", ".join(f"{b} at {c} channels a CTA"
                          for c, b in r["smem_bytes"].items())
                if key.startswith("ring") else "0")
        print(f"[build] selective_scan {key}: "
              f"{r.get('registers', 'not in the log')} registers, "
              f"{r.get('stack_bytes', '?')} bytes stack, "
              f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')} bytes "
              f"spilled (stores/loads), dynamic shared bytes {smem}",
              flush=True)
    return report


def attention_build_report(lib) -> dict:
    """Phase 1 for the bf16 attention kernel, per head-dim template:
    ptxas's registers, stack and spills, the dynamic shared memory of a
    CTA, and the HGMMA instructions in its SASS.  Fails if a template has
    none."""
    from repro_torch.kernels.flash_attention.kernel import bf16_smem_bytes

    def key_of(text):
        m = WGMMA_KERNEL.search(text)
        return f"<{m.group(1)}>" if m else None

    report = ptxas_sass_report("flash_attention", lib, key_of)
    for key, r in report.items():
        r["smem_bytes"] = bf16_smem_bytes(int(key[1:-1]))
    if len(report) != 3 or not all(r.get("hgmma") for r in report.values()):
        fail(f"flash_attention_wgmma_kernel: expected three head-dim "
             f"templates, each with HGMMA instructions in its SASS; got "
             f"{report}")
    for key, r in sorted(report.items(),
                         key=lambda kv: int(kv[0][1:-1])):
        print(f"[build] flash_attention_wgmma_kernel{key} (bf16; head-dim "
              f"template): {r.get('registers', 'not in the log')} "
              f"registers at launch (setmaxnreg: 240 in its two consumer "
              f"warpgroups, 24 in the producer's), "
              f"{r.get('stack_bytes', '?')} bytes stack, "
              f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')} bytes "
              f"spilled (stores/loads), {r['smem_bytes']} bytes dynamic "
              f"shared memory, {r['hgmma']} HGMMA instructions in its SASS",
              flush=True)
    return report


def mlstm_build_report(lib) -> dict:
    """Phase 1 for ``mlstm_chunkwise``: each of its kernels (the product
    kernels per input-type template) with ptxas's registers, stack and
    spills, its dynamic shared memory and its HGMMA count.  Fails unless
    each of the six product kernels has HGMMA instructions."""
    from repro_torch.kernels.mlstm_chunk.kernel import smem_bytes

    def key_of(text):
        m = MLSTM_KERNEL.search(text)
        if not m:
            return None
        return m.group(1) + ("" if m.group(2) is None else
                             ("<bf16>" if m.group(2) == "1" else "<f32>"))

    report = ptxas_sass_report("mlstm_chunk", lib, key_of)
    products = [f"{k}<{t}>" for k in MLSTM_PRODUCTS for t in ("f32", "bf16")]
    if not all(report.get(k, {}).get("hgmma") for k in products):
        fail(f"mlstm_chunkwise: expected HGMMA instructions in the SASS of "
             f"each of {products}; got {report}")
    regs = " (setmaxnreg: 232 in its two consumer warpgroups, 40 in the " \
        "producer's)"
    for key, r in sorted(report.items()):
        r["smem_bytes"] = smem_bytes() if key in products else 0
        print(f"[build] {key}: {r.get('registers', 'not in the log')} "
              f"registers at launch{regs if key in products else ''}, "
              f"{r.get('stack_bytes', '?')} bytes stack, "
              f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')} bytes "
              f"spilled (stores/loads), {r['smem_bytes']} bytes dynamic "
              f"shared memory, {r.get('hgmma', 0)} HGMMA instructions in its "
              f"SASS", flush=True)
    return report


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


def program_table(rng, shape, L, R, kind="random"):
    """A (*shape, L, 4) bytecode table for the apply kernel's edges:
    "random" fusable opcodes with operands from -3 past R and NOPs on about
    half of each row's second half; "tail" the same with a non-NOP last
    instruction in every row (each warp runs all L steps); "nop" every
    row all NOPs (no step runs); "diverse" row r runs opcode
    (r + 5 pc) mod 33 - 2 at pc, so the 32 rows of a warp run 32 different
    opcodes at every pc (those outside the fusable set, negative ones and
    those past the last run as NOP)."""
    import numpy as np
    from repro_torch.kernels.round_fuse import ref as rf_ref
    pool = np.asarray(sorted(rf_ref.FUSABLE_OPS), np.int32)
    n = int(np.prod(shape))
    if kind == "diverse":
        ops = (np.arange(n)[:, None] + 5 * np.arange(L)[None, :]) % 33 - 2
    else:
        ops = rng.choice(pool, (n, L))
        ops[:, L // 2:] = np.where(rng.random((n, L - L // 2)) < 0.5, 0,
                                   ops[:, L // 2:])
    if kind == "tail":
        ops[:, L - 1] = rng.choice(pool[pool != 0], n)
    if kind == "nop":
        ops[:] = 0
    operands = rng.integers(-3, R + 6, (n, L, 3))
    return np.concatenate([ops[..., None], operands], axis=-1).astype(
        np.int32).reshape(*shape, L, 4)


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
    # -- sched_pop at Q=2048, B=64, C=4 (five cases: general, one weight-1
    # tenant with the largest tags, every slot valid with equal keys, 1,024
    # tenants, and a queue of 2,049 slots, no power of two)
    Q, B, C = cfg_defaults.queue, cfg_defaults.batch, cfg_defaults.channels
    err = 0.0
    for case in range(5):
        Qc = Q + 1 if case == 4 else Q
        Tc = 1024 if case == 3 else T
        p = list(queue_case(rng, Qc, C, Tc, cfg_defaults.n_streams))
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
          f"plain version (5 cases: 1,024 tenants and Q={Q + 1} among "
          f"them)", flush=True)

    # -- fused_round at the default widths, N = 4096
    cfg = cfg_defaults
    N, F, M, L, K = cfg.n_streams, cfg.max_out, cfg.max_in, cfg.prog_len, \
        cfg.n_consts
    layout = rf_ref.RegLayout.from_cfg(cfg)
    R = layout.n_regs
    err = 0.0
    kinds = ("random", "random", "tail", "diverse", "nop")
    for case, kind in enumerate(kinds):
        prio, seq, valid, tenant, w_slot, sid, ts, vals = queue_case(
            rng, Q, C, T, N)
        out_table = rng.integers(-1, N, (N, F)).astype(np.int32)
        in_table = rng.integers(-2, N, (N, M)).astype(np.int32)
        progs = program_table(rng, (N,), L, R, kind)
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
        err = max(err, compare(f"fused_round case {case} ({kind} "
                               f"programs)", got, want))
    errs["fused_round"] = err
    print(f"[kernels] fused_round Q={Q} N={N} B={B} F={F} M={M} L={L} "
          f"R={R}: bitwise equal to the plain version ({len(kinds)} cases, "
          f"programs {', '.join(kinds)}; the apply's per-event planes at "
          f"rep = F = {F})", flush=True)

    # -- window_agg: N = 4099 is a multiple of no warp's stream count (32
    # streams at C = 1, 10 at C = 3, 8 at C = 4, 6 at C = 5); C = 40 spans
    # two warps a stream; windows with NaN, -0.0 and subnormals, and empty,
    # full and partial windows; W C % 4 == 0 runs the bulk copies on the
    # aligned store, every shape the 4-byte copies (on a view one float
    # into its buffer where the store itself takes the bulk copies)
    err, cases = window_agg_sweep(torch, dev, rng, WINDOW_SWEEP)
    errs["window_agg"] = err
    print(f"[kernels] window_agg at {len(cases)} cases ({', '.join(cases)}): "
          f"all five outputs bitwise equal to the plain version", flush=True)
    return errs


WINDOW_SWEEP = tuple((4099, W, C) for W in (1, 5, 8, 33, 256, 1024)
                     for C in (1, 3, 4, 5)) + ((99, 8, 40), (99, 33, 40))


def window_case(rng, N, W, C):
    """A window store (N, W, C) ~ 10 N(0, 1) with NaN (canonical and with
    payloads), infinities, -0.0 and subnormals among its entries, streams
    3 and 4 of zeros alternating in sign (from -0.0 and from +0.0), and
    counts from 0 to W: the first five streams empty, full, full, full
    and full, 64 more full."""
    import numpy as np
    v = (rng.standard_normal((N, W, C)) * 10).astype(np.float32)
    flat = v.reshape(-1)
    for x in (np.nan, -0.0, 1e-40, -3e-39, np.inf, -np.inf):
        flat[rng.integers(0, v.size, 64)] = x
    flat[rng.integers(0, v.size, 32)] = np.array(
        [0x7fc12345, 0xffa00001], np.uint32).view(np.float32)[
            rng.integers(0, 2, 32)]
    sign = (np.arange(W) % 2 == 1)[:, None]
    v[3] = np.where(sign, 0.0, -0.0)
    v[4] = np.where(sign, -0.0, 0.0)
    count = rng.integers(0, W + 1, N).astype(np.int32)
    count[:5] = (0, W, W, W, W)
    count[rng.integers(0, N, 64)] = W
    return v, count


def offset_view(torch, values):
    """A copy of ``values`` that starts one float into its buffer: its base
    is not 16-byte aligned, so the window aggregates stage it by 4-byte
    copies."""
    buf = torch.empty(values.numel() + 1, device=values.device)
    view = buf[1:].view(values.shape)
    view.copy_(values)
    return view


def window_agg_sweep(torch, dev, rng, shapes):
    """``window_agg`` bitwise against its plain version at each (N, W, C)
    of ``shapes``, on the aligned store and, where that takes the bulk
    copies, on a view one float into its buffer (the 4-byte copies).
    Returns (max abs error, the cases run)."""
    from repro_torch.kernels.window_agg.kernel import plan_window_agg
    from repro_torch.kernels.window_agg.ops import window_agg
    err, cases = 0.0, []
    for N, W, C in shapes:
        v, count = window_case(rng, N, W, C)
        values = torch.from_numpy(v).to(dev)
        cnt = torch.from_numpy(count).to(dev)
        want = window_agg(values, cnt, use_kernel=False)
        stores = [values]
        while True:
            launch, got = plan_window_agg(stores[-1], cnt)
            launch()
            torch.cuda.synchronize()
            path = launch.plan.staging
            for k in want:
                err = max(err, compare(f"window_agg ({N}, {W}, {C}) {path} "
                                       f"{k}", got[k], want[k]))
            cases.append(f"({N}, {W}, {C}) {path}")
            if path != "bulk":
                break
            stores.append(offset_view(torch, values))
    return err, cases


def exchange_case(rng, D, W, C, E, mode):
    """Work items of D senders for ``exchange_compact``: ``mode``
    "mixed" (random destinations, a quarter unrouted, some dest past D),
    "one" (every routed item to shard 0, so buckets overflow), "all"
    (every item routed to the last shard) or "none" (every lane
    unrouted); NaN, -0.0, inf and subnormal payloads."""
    import numpy as np
    wi_t = rng.integers(-1, 50000, (D, W)).astype(np.int32)
    wi_src = rng.integers(-5, 50000, (D, W)).astype(np.int32)
    wi_ts = rng.integers(-2**31 + 1, 2**31 - 1, (D, W)).astype(np.int32)
    wi_its = rng.integers(0, 1 << 20, (D, W)).astype(np.int32)
    vals = rng.standard_normal((D, W, C)).astype(np.float32)
    flat = vals.reshape(-1)
    for x in (np.nan, -0.0, np.inf, 1e-40):
        flat[rng.integers(0, flat.size, 16)] = x
    flat[rng.integers(0, flat.size, 4)] = np.frombuffer(
        np.uint32(0x7fc12345).tobytes(), np.float32)[0]      # NaN payload
    if mode == "mixed":
        dest = rng.integers(0, D + 2, (D, W)).astype(np.int32)
        dest[rng.random((D, W)) < 0.25] = D
    elif mode == "one":
        dest = np.where(rng.random((D, W)) < 0.9, 0, D).astype(np.int32)
    elif mode == "all":
        dest = np.full((D, W), D - 1, np.int32)
    else:
        dest = np.full((D, W), D, np.int32)
    return wi_t, wi_src, wi_ts, wi_its, vals, dest


def apply_case(rng, cfg, S, n_tab, n_snap, W, kind="random"):
    """Inputs of the sharded post-exchange apply: S shards of ``n_tab``
    table rows and W items each, against one ``n_snap``-row snapshot.
    Rows and targets in range (the round clips them); co-input sids from
    -2 past n_snap; bytecode of ``program_table``'s ``kind`` ("diverse":
    item w on row w mod n_tab, so a warp's lanes run different rows);
    NaN, -0.0 and subnormal snapshot values; revoked and non-composite
    rows; a random item mask."""
    import numpy as np
    from repro_torch.kernels.round_fuse import ref as rf_ref
    M, L, K, C = cfg.max_in, cfg.prog_len, cfg.n_consts, cfg.channels
    R = rf_ref.RegLayout.from_cfg(cfg).n_regs
    progs = program_table(rng, (S, n_tab), L, R, kind)
    values = rng.standard_normal((n_snap, C)).astype(np.float32)
    values.ravel()[rng.integers(0, n_snap * C, 16)] = np.nan
    values.ravel()[rng.integers(0, n_snap * C, 16)] = -0.0
    values.ravel()[rng.integers(0, n_snap * C, 8)] = 1e-40
    vals = rng.standard_normal((S, W, C)).astype(np.float32)
    vals.ravel()[rng.integers(0, vals.size, 8)] = np.nan
    rows = rng.integers(0, n_tab, (S, W)).astype(np.int32)
    if kind == "diverse":
        rows[:] = np.arange(W) % n_tab
    return (rng.integers(-2, n_snap + 4, (S, n_tab, M)).astype(np.int32),
            progs, rng.standard_normal((S, n_tab, K)).astype(np.float32),
            rng.random((S, n_tab)) < 0.75, rng.random((S, n_tab)) < 0.9,
            rows, rng.integers(0, n_snap, (S, W)).astype(np.int32),
            rng.integers(-3, n_snap + 3, (S, W)).astype(np.int32), vals,
            rng.integers(-5, 40, (S, W)).astype(np.int32),
            rng.random((S, W)) < 0.8, values,
            rng.integers(-5, 40, n_snap).astype(np.int32))


def limit_prog_len(cfg) -> int:
    """The longest program ``apply_programs`` takes at ``cfg``'s other
    widths: the CTA's staged planes then fill the shared-memory limit."""
    from repro_torch.kernels.round_fuse import kernel as rk
    from repro_torch.kernels.round_fuse import ref as rf_ref
    layout = rf_ref.RegLayout.from_cfg(cfg)
    L = 1
    while rk.apply_smem_bytes(layout, L + 1, cfg.n_consts) <= rk.SMEM_LIMIT:
        L += 1
    return L


def phase_shard_kernels(torch, dev, cfg, D):
    """``apply_programs`` and ``exchange_compact`` bitwise against their
    plain versions: the smoke shapes of the D-shard round (W = batch x
    max_out items per sender, E = W slots; D x E applied items per shard,
    n_local = N / D table rows against an N-row snapshot) and adversarial
    cases.  Returns the max abs error of each (0.0)."""
    import ctypes
    import dataclasses
    import numpy as np
    from repro_torch.kernels.round_fuse import kernel as rk
    from repro_torch.kernels.round_fuse import ref as rf_ref
    from repro_torch.kernels.round_fuse.kernel import (apply_programs_call,
                                                       exchange_compact_call)
    from repro_torch.kernels.round_fuse.ops import (apply_programs,
                                                    exchange_compact)
    rng = np.random.default_rng(SEED + 3)
    layout = rf_ref.RegLayout.from_cfg(cfg)
    W, N = cfg.work, cfg.n_streams
    err_x, shapes = 0.0, []
    C = cfg.channels
    for (Dx, Wx, E, mode, Cx) in [
            (D, W, W, "mixed", C), (D, W, 64, "mixed", C),
            (D, W, 64, "one", C), (D, W, W, "none", C),
            (1, 1000, 7, "mixed", C), (2, 77, 5, "one", C),
            (3, 1000, 300, "mixed", C), (8, 1024, 100, "mixed", C),
            (8, 129, 1, "one", C), (32, W, 40, "mixed", C),
            (D, W, 1000, "all", C), (D, 1, 5, "mixed", C),
            (2, 5000, 1000, "mixed", C), (3, 5000, 2000, "one", C),
            (D, W, 300, "mixed", 1), (D, W, W, "one", 3)]:
        case = [torch.from_numpy(a).to(dev)
                for a in exchange_case(rng, Dx, Wx, Cx, E, mode)]
        got = exchange_compact_call(*case, Dx, E)
        want = exchange_compact(*case, Dx, E, use_kernel=False)
        torch.cuda.synchronize()
        err_x = max(err_x, compare(f"exchange_compact D={Dx} W={Wx} E={E} "
                                   f"{mode} C={Cx}", got, want))
        shapes.append(f"({Dx}, {Wx}, E={E}, {mode}, C={Cx})")
    print(f"[kernels] exchange_compact at {', '.join(shapes)}: buckets, "
          f"payload bits and overflow mask bitwise equal to the plain "
          f"version", flush=True)
    err_a, shapes = 0.0, []
    c1, c3 = (dataclasses.replace(cfg, channels=c).validate() for c in (1, 3))
    at_limit = dataclasses.replace(cfg, prog_len=limit_prog_len(cfg))
    # the wrapper's fit check and the launcher reckon the same CTA
    lib = rk._lib()
    for L in (cfg.prog_len, at_limit.prog_len):
        c_bytes = lib.apply_programs_smem((ctypes.c_int * 10)(*layout), L,
                                          cfg.n_consts)
        if c_bytes != rk.apply_smem_bytes(layout, L, cfg.n_consts) or \
                lib.apply_programs_items() != rk.APPLY_ITEMS:
            fail(f"apply_programs: the launcher gives {c_bytes} shared "
                 f"bytes to a CTA of {lib.apply_programs_items()} items at "
                 f"L={L}, the wrapper's check reckons "
                 f"{rk.apply_smem_bytes(layout, L, cfg.n_consts)} for "
                 f"{rk.APPLY_ITEMS}")
    for (cf, S, n_tab, n_snap, Wa, kind) in [
            (cfg, D, N // D, N, D * W, "random"),
            (cfg, 3, 100, 333, 257, "random"), (cfg, 1, 64, 64, 130, "random"),
            (cfg, D, N // D, N, D * W, "tail"), (cfg, 2, 50, 90, 300, "nop"),
            (cfg, D, N // D, N, D * W, "diverse"),
            (cfg, 2, 40, 100, 1001, "diverse"), (c1, 3, 70, 200, 333, "tail"),
            (c3, 2, 90, 150, 517, "random"), (at_limit, 1, 48, 64, 99, "tail")]:
        lay = rf_ref.RegLayout.from_cfg(cf)
        c = [torch.from_numpy(a).to(dev)
             for a in apply_case(rng, cf, S, n_tab, n_snap, Wa, kind)]
        got = apply_programs_call(lay, *c)
        want = apply_programs(lay, *c, use_kernel=False)
        torch.cuda.synchronize()
        err_a = max(err_a, compare(
            f"apply_programs S={S} n_tab={n_tab} n_snap={n_snap} W={Wa} "
            f"C={cf.channels} L={cf.prog_len} {kind}", got, want))
        shapes.append(f"{S} x {Wa} items, {n_tab} rows, {n_snap} snapshot "
                      f"rows, C={cf.channels}, L={cf.prog_len}, {kind}")
    print(f"[kernels] apply_programs at {'; '.join(shapes)} (L="
          f"{at_limit.prog_len}: "
          f"{rk.apply_smem_bytes(layout, at_limit.prog_len, cfg.n_consts)} "
          f"shared bytes a CTA of {rk.APPLY_ITEMS} items, the limit "
          f"{rk.SMEM_LIMIT}): all seven outputs bitwise equal to the plain "
          f"version", flush=True)
    return {"exchange_compact": err_x, "apply_programs": err_a}


FLOAT_SPECIALS = (0x80000000, 0x00000001, 0x807fffff, 0x7fc12345,
                  0xffa00001, 0x7f800000, 0xff800000)   # -0.0, subnormals,
#                 NaN payloads, +inf, -inf


def gather_case(rng, N, F, M, dtype):
    """A table and ids for ``onehot_gather``: ids from -2 to N + 1; int32
    entries over the whole range, or float32 entries with -0.0,
    subnormals, NaN payloads and infinities among them."""
    import numpy as np
    if dtype == "int32":
        table = rng.integers(-2**31, 2**31 - 1, (N, F)).astype(np.int32)
    else:
        table = rng.standard_normal((N, F)).astype(np.float32)
        table.reshape(-1)[rng.integers(0, N * F, 2 * len(
            FLOAT_SPECIALS))] = np.array(FLOAT_SPECIALS * 2,
                                         np.uint32).view(np.float32)
    return table, rng.integers(-2, N + 2, M).astype(np.int32)


def snapshot_case(rng, S, L, C, M):
    """S shards' (L, C) float32 value planes with -0.0, subnormals, NaN
    payloads and infinities, their (L,) int32 timestamps over the whole
    range, and M ids from -2 to S L + 1 for ``by_sid_snapshot``."""
    import numpy as np
    vals, ts = [], []
    for _ in range(S):
        v = rng.standard_normal((L, C)).astype(np.float32)
        v.reshape(-1)[rng.integers(0, L * C, len(FLOAT_SPECIALS))] = \
            np.array(FLOAT_SPECIALS, np.uint32).view(np.float32)
        t = rng.integers(-2**31, 2**31 - 1, L).astype(np.int32)
        t[rng.integers(0, L, 2)] = (-2**31, 2**31 - 1)
        vals.append(v)
        ts.append(t)
    return vals, ts, rng.integers(-2, S * L + 2, M).astype(np.int32)


def dispatch_case(rng, B, F, n_tab, N):
    """Events and tables for ``stream_dispatch``: valid events with sids
    outside [0, n_tab), out-table entries below -1 and at or past the N
    timestamps, INT32_MIN and INT32_MAX event and table timestamps."""
    import numpy as np
    sid = rng.integers(-3, n_tab + 3, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    sid[:3], valid[:3] = (-1, n_tab, n_tab + 2), True
    ts = rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)
    ts[3:5] = (-2**31, 2**31 - 1)
    out_table = rng.integers(-6, N + 8, (n_tab, F)).astype(np.int32)
    tstab = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    tstab[rng.integers(0, N, 2)] = (-2**31, 2**31 - 1)
    return sid, ts, valid, out_table, tstab


def phase_dispatch_kernels(torch, dev, cfg, D):
    """``onehot_gather`` and ``stream_dispatch`` bitwise against their
    plain versions: the sweeps of ``tests/test_kernels.py``, the smoke
    shapes ((N, F) = (4096, 16) out-table, B = 64; the (4096, 4) value
    snapshot gathered by 4,096 ids), the D-shard shape (a (N / D, 16)
    shard out-table against N timestamps), both ``with_early`` values,
    and adversarial inputs.  Returns the max abs error of each (0.0)."""
    import numpy as np
    from repro_torch.kernels.stream_dispatch.kernel import (
        by_sid_snapshot_call, onehot_gather_call, stream_dispatch_call)
    from repro_torch.kernels.stream_dispatch.ops import (by_sid_snapshot,
                                                         onehot_gather,
                                                         stream_dispatch)
    rng = np.random.default_rng(SEED + 5)
    N, F, B, C = cfg.n_streams, cfg.max_out, cfg.batch, cfg.channels
    err_g, shapes = 0.0, []
    for (Ng, Fg, M) in [(64, 4, 16), (300, 7, 33), (1024, 16, 256),
                        (128, 1, 8), (N, F, B), (N, C, N), (N // D, F, B)]:
        for dtype in ("int32", "float32"):
            table, ids = (torch.from_numpy(a).to(dev)
                          for a in gather_case(rng, Ng, Fg, M, dtype))
            got = onehot_gather_call(table, ids)
            want = onehot_gather(table, ids, use_kernel=False)
            torch.cuda.synchronize()
            err_g = max(err_g, compare(f"onehot_gather ({Ng}, {Fg}) "
                                       f"{dtype} M={M}", got, want))
        shapes.append(f"({Ng}, {Fg}) x {M}")
    print(f"[kernels] onehot_gather at {', '.join(shapes)}, int32 and "
          f"float32 tables (ids -2..N+1; -0.0, subnormals, NaN payloads, "
          f"infinities): bitwise equal to the plain version", flush=True)
    err_s, shapes = 0.0, []
    for (S, L, Cs, M) in [(1, 64, 4, 77), (2, 300, 4, 513), (4, N // D, C, N),
                          (4, 97, 3, 200), (3, 50, 1, 64), (2, 64, 6, 100)]:
        vals, ts, ids = snapshot_case(rng, S, L, Cs, M)
        vals = [torch.from_numpy(x).to(dev) for x in vals]
        ts = [torch.from_numpy(x).to(dev) for x in ts]
        ids = torch.from_numpy(ids).to(dev)
        got = by_sid_snapshot_call(vals, ts, ids)
        want = by_sid_snapshot(vals, ts, ids, use_kernel=False)
        torch.cuda.synchronize()
        err_s = max(err_s, compare(f"by_sid_snapshot {S} x ({L}, {Cs}) "
                                   f"M={M}", got, want))
        shapes.append(f"{S} x ({L}, {Cs}) x {M}")
    # a shard plane that is a view 4 bytes past a 16-byte boundary takes
    # the 4-byte words
    flat = torch.from_numpy(snapshot_case(rng, 1, 129, 4, 1)[0][0]).to(dev)
    flat = flat.reshape(-1)
    planes = [flat[1:513].view(128, 4), flat[:512].view(128, 4)]
    tss = [torch.arange(128, dtype=torch.int32, device=dev),
           torch.arange(128, dtype=torch.int32, device=dev) * -3]
    ids = torch.arange(-1, 257, dtype=torch.int32, device=dev)
    err_s = max(err_s, compare(
        "by_sid_snapshot unaligned planes",
        by_sid_snapshot_call(planes, tss, ids),
        by_sid_snapshot(planes, tss, ids, use_kernel=False)))
    print(f"[kernels] by_sid_snapshot at {', '.join(shapes)} and two "
          f"unaligned plane views (ids -2..S L+1; -0.0, subnormals, NaN "
          f"payloads, infinities; INT32_MIN/MAX timestamps): values and "
          f"timestamps bitwise equal to the plain version", flush=True)
    err_g = max(err_g, err_s)
    err_d, shapes = 0.0, []
    for (n_tab, Nd, Fd, Bd) in [(64, 64, 4, 16), (256, 256, 16, 64),
                                (N, N, F, B), (N // D, N, F, B),
                                (300, 97, 3, 20), (1, 5, 1, 5)]:
        args = [torch.from_numpy(a).to(dev)
                for a in dispatch_case(rng, Bd, Fd, n_tab, Nd)]
        for with_early in (True, False):
            got = stream_dispatch_call(*args, with_early=with_early)
            want = stream_dispatch(*args, with_early=with_early,
                                   use_kernel=False)
            torch.cuda.synchronize()
            tag = f"stream_dispatch ({n_tab}, {Fd}) vs {Nd} B={Bd}"
            err_d = max(err_d, compare(f"{tag} targets", got[0], want[0]))
            if with_early:
                err_d = max(err_d, compare(f"{tag} early", got[1], want[1]))
            elif got[1] is not None or want[1] is not None:
                fail(f"{tag}: a mask without with_early")
        shapes.append(f"({n_tab}, {Fd}) vs {Nd} x B={Bd}")
    print(f"[kernels] stream_dispatch at {', '.join(shapes)}, with_early "
          f"True and False (valid events with out-of-range sids, entries "
          f"< -1 and >= N, INT32_MIN/MAX timestamps): targets and early "
          f"masks bitwise equal to the plain version", flush=True)
    return {"onehot_gather": err_g, "stream_dispatch": err_d}


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


def drive(torch, eng, sources, rounds, seed, per_round, warmup=0,
          at_warm=None):
    """Post ``per_round`` SUs to distinct random sources and run one
    round, ``rounds`` times.  Returns the sinks of every round and the
    wall seconds of the rounds after the first ``warmup`` (``at_warm()``
    is called just before them)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sinks = []
    for r in range(rounds):
        if r == warmup:
            if at_warm is not None:
                at_warm()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for j in rng.choice(len(sources), per_round, replace=False):
            eng.post(sources[j], rng.standard_normal(4).tolist(),
                     r * 10 + int(rng.integers(0, 9)))
        sinks.append(eng.round())
    torch.cuda.synchronize()
    return sinks, time.perf_counter() - t0


def plain_engine(reg, dev):
    """An engine on the card whose rounds run the kernels' plain torch
    versions: the history the kernels are held against."""
    from repro_torch.core import create_engine
    return create_engine(reg, device=dev, use_kernel=False)


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
# phases 4 and 6: supersteps against eager rounds
# --------------------------------------------------------------------------

def guard_rounds(torch, eng) -> None:
    """Run every superstep's K rounds of ``eng`` under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
    between the staging copy and the spool readback raises there."""
    run = eng._run_superstep

    def guarded(K):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(K)
        except RuntimeError as e:
            fail(f"host synchronisation inside a superstep's rounds: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)

    eng._run_superstep = guarded


def host_sink(sink):
    """A per-round sink of host arrays as tensors (for ``compare``)."""
    import torch
    return tuple(torch.from_numpy(x) for x in sink)


def phase_superstep(torch, dev, reg, sources, path, K, n_steps, counter,
                    counters):
    """``n_steps`` supersteps of K rounds on one engine against
    ``n_steps * K`` eager rounds on another, both through the kernels,
    with the same posts before each group of K rounds (K * batch SUs to
    random sources, repeats included, so bursts carry over).  Every
    per-round sink and, at the end, every state leaf and stat must agree
    bitwise.  Returns (ms per superstep, ms per eager round), over the
    steps after the first."""
    import numpy as np
    from repro_torch.core import create_engine
    e_step = create_engine(reg, device=dev)
    e_round = create_engine(reg, device=dev)
    for e in (e_step, e_round):
        if e._path != path:
            fail(f"expected the {path} path, engine took {e._path}")
    guard_rounds(torch, e_step)
    rng = np.random.default_rng(SEED + 7)
    B = reg.cfg.batch
    t_step = t_round = 0.0
    for c in counters:
        c.launches = 0
    for s in range(n_steps):
        picks = rng.integers(0, len(sources), K * B)
        vals = rng.standard_normal((K * B, 4)).astype(np.float32)
        ts = s * 100 + rng.integers(0, 90, K * B)
        for e in (e_step, e_round):
            for j, v, t in zip(picks, vals, ts):
                e.post(sources[j], v.tolist(), int(t))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sinks = e_step.spool_sinks(e_step.superstep(K))
        t1 = time.perf_counter()
        rounds = [e_round.round() for _ in range(K)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if s > 0:
            t_step += t1 - t0
            t_round += t2 - t1
        for k, (a, b) in enumerate(zip(sinks, rounds)):
            compare(f"{path} superstep {s} round {k}", host_sink(a),
                    tuple(b))
    if counter.launches != 2 * n_steps * K:
        fail(f"{path} supersteps: {counter.__name__} launched "
             f"{counter.launches} times in 2 x {n_steps * K} rounds")
    compare_engines(f"{path} superstep", e_step, [], e_round, [])
    c = e_step.counters()
    if c["emitted"] == 0 or c != e_round.counters():
        fail(f"{path} supersteps: counters {c} vs {e_round.counters()}")
    timed = n_steps - 1
    ms_step, ms_round = t_step / timed * 1e3, t_round / (timed * K) * 1e3
    print(f"[{path} superstep] {n_steps} supersteps of K={K} bitwise equal "
          f"to {n_steps * K} eager rounds (every sink, state leaf and stat); "
          f"no host synchronisation inside the K rounds; "
          f"{counter.__name__} launches {counter.launches}; steps 2-"
          f"{n_steps}: {ms_step} ms per superstep (staging and spool "
          f"readback included) vs K x {ms_round} = {K * ms_round} ms of "
          f"eager rounds; emitted={c['emitted']} pending "
          f"{len(e_step._pending)}", flush=True)
    return ms_step, ms_round


# --------------------------------------------------------------------------
# phase 7: the IoT suite at full width
# --------------------------------------------------------------------------

SUITE = dict(n_tenants=1024, batch=64, queue=2048, window=256, rounds=32,
             K=8)
# trace rounds of the full-width suite on 4 shards (phase 11): its plain
# version takes ~0.4 s a round there, so 32 rounds cost two minutes.  At 8
# (12 supersteps, 96 rounds) its queues still settle: the records' p99 is 7
# rounds.
SHARDED_SUITE_ROUNDS = 8


def run_suite(torch, dev, use_kernel, counters, n_shards=1, rounds=32):
    """Build the full-width suite on ``n_shards`` shards and replay its
    trace of ``rounds`` rounds once; every launch counter is 0 just before
    ``drive``.  Returns
    (suite, drive's result, the latency records of every superstep, wall
    seconds of ``drive``)."""
    from repro_torch.workloads import TraceConfig, build_suite, drive
    suite = build_suite(
        SUITE["n_tenants"], kinds=("etl", "stats"), batch=SUITE["batch"],
        queue=SUITE["queue"], window=SUITE["window"], n_shards=n_shards,
        trace=TraceConfig(n_devices=SUITE["n_tenants"],
                          rounds=rounds, seed=0),
        cfg_overrides={"superstep": SUITE["K"]}, device=dev,
        use_kernel=use_kernel)
    if suite.engine._path != "fused":
        fail(f"the IoT suite took the {suite.engine._path} path")
    log = []
    records = suite.engine.latency_records

    def logged(source, base=None):
        out = records(source, base)
        log.append(out)
        return out

    suite.engine.latency_records = logged
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = drive(suite, SUITE["K"])
    torch.cuda.synchronize()
    return suite, out, log, time.perf_counter() - t0


def phase_suite(torch, dev, counters, n_shards=1):
    """The suite on ``n_shards`` shards through the kernels and through
    their plain versions, compared bitwise; returns (kernel suite,
    launches per kernel)."""
    import numpy as np
    tag = "suite" if n_shards == 1 else f"sharded suite D={n_shards}"
    trace = SUITE["rounds"] if n_shards == 1 else SHARDED_SUITE_ROUNDS
    t0 = time.perf_counter()
    sp, outp, logp, _ = run_suite(torch, dev, False, counters, n_shards,
                                  trace)
    build_and_plain = time.perf_counter() - t0
    sk, outk, logk, wall = run_suite(torch, dev, None, counters, n_shards,
                                     trace)
    launches = {c.__name__: c.launches for c in counters}
    n_steps = trace + 4
    rounds = n_steps * SUITE["K"]
    want = {"fused_round_call": rounds} if n_shards == 1 else {
        "sched_pop_call": n_shards * rounds, "apply_programs_call": rounds,
        "exchange_compact_call": rounds, "by_sid_snapshot_call": rounds}
    if any(launches[k] != n for k, n in want.items()) \
            or launches["window_agg_call"] < 1:
        fail(f"IoT {tag}: launches {launches} in {n_steps} supersteps")
    compare_engines(tag, sk.engine, [], sp.engine, [])
    if len(logk) != len(logp):
        fail(f"IoT {tag}: a different number of latency readbacks")
    for i, (a, b) in enumerate(zip(logk, logp)):
        for key in a:
            compare(f"{tag} records {i} {key}", torch.from_numpy(a[key]),
                    torch.from_numpy(b[key]))
    if not (np.array_equal(sk.slo.hist, sp.slo.hist)
            and np.array_equal(sk.slo.violations, sp.slo.violations)
            and outk["slo_report"] == outp["slo_report"]
            and outk["records"] == outp["records"] > 0):
        fail(f"IoT {tag}: SLO histograms or report differ")
    for f in sk.stats.store._fields:
        compare(f"{tag} window store {f}", getattr(sk.stats.store, f),
                getattr(sp.stats.store, f))
    for k in outk["aggregates"]:
        compare(f"{tag} aggregate {k}",
                torch.from_numpy(outk["aggregates"][k]),
                torch.from_numpy(outp["aggregates"][k]))
    c = sk.engine.counters()
    spooled = sum(int(r["sid"].size) for r in logk)
    rep = outk["slo_report"]["total"]
    print(f"[{tag}] {SUITE['n_tenants']} tenants (ETL + STATS), "
          f"{sk.registry.n_active} streams, window store "
          f"{tuple(sk.stats.store.values.shape)} = "
          f"{sk.stats.store.values.numel() * 4 / 1e6} MB: kernels bitwise "
          f"equal to the plain versions (state, {len(logk)} latency "
          f"readbacks, SLO histograms and report, window store, five "
          f"aggregates); launches {launches}; drive() wall {wall} s for "
          f"{n_steps} supersteps of K={SUITE['K']}: {n_steps / wall} "
          f"supersteps/s, {outk['records']} terminal-sink records = "
          f"{outk['records'] / wall} records/s ({spooled} spooled "
          f"emissions); latency p50/p95/p99 {rep['p50']}/{rep['p95']}/"
          f"{rep['p99']} rounds; processed={c['processed']} "
          f"emitted={c['emitted']} dropped_overflow={c['dropped_overflow']}; "
          f"plain run incl. build {build_and_plain} s", flush=True)
    return sk, launches


# --------------------------------------------------------------------------
# phases 8-11: the sharded plane (shards emulated on the one card)
# --------------------------------------------------------------------------

SHARDS = 4


def copy_registry(reg, **cfg):
    """An independent copy of ``reg`` (same sids, tenants, programs) with
    config fields replaced: each engine of a churn run needs its own
    registry, since admission edits the registry too."""
    from repro_torch.core import Registry
    snap = reg.to_snapshot()
    snap["cfg"] = dict(snap["cfg"], **cfg)
    return Registry.from_snapshot(snap)


def table_ptrs(eng):
    """Storage of every table and of the program table the round reads
    (cut to the step bound): live churn must move none of them."""
    ptrs = {f: getattr(eng.tables, f).data_ptr() for f in eng.tables._fields}
    ptrs["run/progs"] = eng._run_tables.progs.data_ptr()
    return ptrs


def churn(engines, w, rng):
    """One churn step on every engine alike: admit a composite over two
    random sources, revoke the one admitted two steps earlier, swap the
    program of a random composite, and ``rebalance`` the sharded engines
    (the queues are drained here).  Returns what was done."""
    regs = [e.registry for e in engines]
    srcs = [s.sid for s in regs[0].streams if s is not None
            and not s.composite]
    comps = [s.sid for s in regs[0].streams if s is not None and s.composite
             and not s.name.startswith("churn") and s.name != "hot"]
    picks = rng.choice(srcs, 2, replace=False)
    swap = int(rng.choice(comps))
    t = int(rng.integers(len(regs[0].tenants)))
    out = []
    for e in engines:
        r = e.registry
        s = e.admit_composite(
            r.tenants[t], f"churn{w}", CHANNELS,
            [r.streams[int(j)] for j in picks],
            {ch: f"in0.{ch} * 0.5 + in1.{ch} - {w}.0" for ch in CHANNELS})
        out.append(None if s is None else s.sid)
        old = [x for x in r.streams
               if x is not None and x.name == f"churn{w - 2}"]
        if old:
            e.revoke_stream(old[0])
        e.swap_program(r.streams[swap], {ch: f"in0.{ch} * {w % 5 + 1}.5"
                                         for ch in CHANNELS})
    if len(set(out)) != 1:
        fail(f"churn: engines admitted different sids {out}")
    done = [f"admit sid {out[0]}", f"swap sid {swap}"]
    moved = [e.rebalance() for e in engines if hasattr(e, "rebalance")]
    if len(set(moved)) > 1:
        fail(f"churn: rebalance moved {moved}")
    if moved:
        done.append(f"rebalance {moved[0]}")
    return done


def global_view(eng):
    """(values, timestamps) by sid, as host arrays, for either layout."""
    if hasattr(eng, "plan"):
        return (eng._by_sid(eng.state.values), eng._by_sid(
            eng.state.timestamps))
    return eng.state.values.cpu().numpy(), eng.state.timestamps.cpu().numpy()


def phase_sharded(torch, dev, reg, sources, path, counters, waves, heavy,
                  warm):
    """The sharded round at the smoke cell's width (``EngineConfig``
    defaults, D = SHARDS, ``exchange_slots=0``: E = W = 1,024 slots, D x E
    applied items per shard), through the kernels and through their plain
    versions, with live churn every third wave (admit, revoke, swap,
    rebalance — table storage unchanged).  ``waves`` waves of two SUs,
    each drained: every round pops fewer SUs than the batch, so on the
    fused path a single-device engine run alike must hold the same global
    values, timestamps and counters.  Then ``heavy`` rounds that each post
    64 SUs, kernels against plain, the rounds after the first ``warm``
    timed.  The engine ingests at most ``cfg.batch`` SUs per round across
    all shards (as the JAX package's sharded engine does), so the shards'
    pops fill from the composites' emission backlog that the warm-up
    rounds build; the pops' fill over the timed rounds is printed.  Every
    launch counter is 0 just before the drive; returns (kernel engine,
    launches, ms per timed heavy round)."""
    import numpy as np
    from repro_torch.core import create_engine
    kw = dict(n_shards=SHARDS, exchange_slots=0)
    e_k = create_engine(copy_registry(reg, **kw), device=dev)
    e_p = plain_engine(copy_registry(reg, **kw), dev)
    engines = [e_k, e_p]
    e_1 = None
    if path == "fused":
        e_1 = create_engine(copy_registry(reg, exchange_slots=0), device=dev)
        engines.append(e_1)
    for e in engines:
        if e._path != path:
            fail(f"sharded {path}: the engine took the {e._path} path")
    ptrs = [table_ptrs(e) for e in (e_k, e_p)]
    rng = np.random.default_rng(SEED + 11)
    for c in counters:
        c.launches = 0
    rounds, log, max_occ = 0, [], 0
    for w in range(waves):
        if w % 3 == 2:
            log += churn(engines, w, rng)
        picks = rng.choice(len(sources), 2, replace=False)
        for j in picks:
            v = rng.standard_normal(4).tolist()
            for e in engines:
                e.post(sources[j], v, 1000 * (w + 1) + int(j) % 7)
        drained = []
        for e in engines:
            sinks = []
            for _ in range(256):
                busy = bool(e._pending)
                sinks.append(e.round())
                if e is e_1:
                    max_occ = max(max_occ, int(e.state.q_valid.sum()))
                if not busy and not bool(e.state.q_valid.any()):
                    break
            drained.append(sinks)
        rounds += len(drained[0])
        compare_engines(f"sharded {path} wave {w}", e_k, drained[0], e_p,
                        drained[1])
        if e_1 is not None:
            (vk, tk), (v1, t1) = global_view(e_k), global_view(e_1)
            if not (np.array_equal(vk.view(np.int32), v1.view(np.int32))
                    and np.array_equal(tk, t1)
                    and e_k.counters() == e_1.counters()):
                fail(f"sharded fused wave {w}: the {SHARDS}-shard engine "
                     f"differs from the single-device engine (max queue "
                     f"occupancy {max_occ} of batch {reg.cfg.batch})")
    per_round = reg.cfg.batch
    popped = []
    s_k, secs = drive(torch, e_k, sources, heavy, SEED + 12, per_round,
                      warmup=warm, at_warm=lambda: popped.append(
                          e_k.counters()["popped"]))
    s_p, _ = drive(torch, e_p, sources, heavy, SEED + 12, per_round)
    timed = heavy - warm
    popped = e_k.counters()["popped"] - popped[0]
    slots = timed * SHARDS * reg.cfg.batch
    ms = secs / timed * 1e3
    rounds += heavy
    launches = {c.__name__: c.launches for c in counters}
    compare_engines(f"sharded {path} heavy", e_k, s_k, e_p, s_p)
    if [table_ptrs(e) for e in (e_k, e_p)] != ptrs:
        fail(f"sharded {path}: an edit or a round reallocated a table")
    want = {"sched_pop_call": SHARDS * rounds, "exchange_compact_call": rounds,
            "by_sid_snapshot_call": rounds,
            "apply_programs_call": rounds if path == "fused" else 0}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"sharded {path}: {name} launched {launches[name]} times "
                 f"in {rounds} rounds of {SHARDS} shards (want {n})")
    c = e_k.counters()
    print(f"[sharded {path}] {SHARDS} shards x {e_k.plan.n_local} rows, "
          f"E={e_k.cfg.exchange}: {waves} drained waves with churn "
          f"({'; '.join(log)}) and {heavy} heavy rounds of {per_round} "
          f"posted SUs (timed rounds {warm + 1}-{heavy}: {popped} popped "
          f"of {slots} pop slots = {popped / slots} fill), "
          f"{rounds} rounds in all: kernels bitwise equal to the plain "
          f"versions (every state leaf, stat and sink); "
          + (f"{SHARDS}-shard values, timestamps and counters equal to the "
             f"single-device engine after every wave (max queue occupancy "
             f"{max_occ} of batch {reg.cfg.batch}); " if e_1 else "")
          + f"table storage unchanged; launches {launches}; heavy rounds "
          f"{warm + 1}-{heavy}: {ms} ms/round; processed={c['processed']} "
          f"emitted={c['emitted']} dropped_overflow={c['dropped_overflow']}",
          flush=True)
    return e_k, launches, ms


SHARD_SUITE = dict(n_tenants=128, batch=64, queue=2048, window=256,
                   rounds=16, K=8)


def phase_shard_suite(torch, dev, counters):
    """The IoT suite at D = SHARDS against D = 1, both through the
    kernels, at 128 tenants: a load every round drains at D = 1, so the
    sharded engine must give the same latency records, SLO histograms,
    report, window aggregates and counters."""
    import numpy as np
    from repro_torch.workloads import TraceConfig, build_suite, drive
    out = []
    for D in (1, SHARDS):
        suite = build_suite(
            SHARD_SUITE["n_tenants"], kinds=("etl", "stats"),
            batch=SHARD_SUITE["batch"], queue=SHARD_SUITE["queue"],
            window=SHARD_SUITE["window"], n_shards=D,
            trace=TraceConfig(n_devices=SHARD_SUITE["n_tenants"],
                              rounds=SHARD_SUITE["rounds"], seed=0),
            cfg_overrides={"superstep": SHARD_SUITE["K"]}, device=dev)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = drive(suite, SHARD_SUITE["K"])
        torch.cuda.synchronize()
        out.append((suite, res, time.perf_counter() - t0,
                    {c.__name__: c.launches for c in counters}))
    (s1, r1, w1, l1), (sD, rD, wD, lD) = out
    if lD["apply_programs_call"] == 0 or lD["exchange_compact_call"] == 0:
        fail(f"sharded suite: launches {lD}")
    if not (np.array_equal(s1.slo.hist, sD.slo.hist)
            and r1["slo_report"] == rD["slo_report"]
            and r1["records"] == rD["records"] > 0
            and s1.engine.counters() == sD.engine.counters()):
        fail(f"sharded suite: D={SHARDS} differs from D=1 "
             f"({rD['slo_report']['total']} vs {r1['slo_report']['total']})")
    n = r1["aggregates"]["sum"].shape[0]    # D > 1 pads the sid space
    for k in r1["aggregates"]:
        compare(f"sharded suite aggregate {k}",
                torch.from_numpy(rD["aggregates"][k][:n]),
                torch.from_numpy(r1["aggregates"][k]))
    rep = rD["slo_report"]["total"]
    n_steps = SHARD_SUITE["rounds"] + 4
    print(f"[sharded suite] {SHARD_SUITE['n_tenants']} tenants, "
          f"{sD.registry.n_active} streams: D={SHARDS} equal to D=1 "
          f"(latency histograms, SLO report, {rD['records']} records, window "
          f"aggregates, counters); p50/p95/p99 {rep['p50']}/{rep['p95']}/"
          f"{rep['p99']} rounds; drive() {n_steps} supersteps of "
          f"K={SHARD_SUITE['K']}: D=1 {w1} s, D={SHARDS} {wD} s; launches "
          f"D=1 {l1}, D={SHARDS} {lD}", flush=True)


# --------------------------------------------------------------------------
# phase 12: the engine with the stream-dispatch fan-out
# --------------------------------------------------------------------------

FANOUTS = ("kernel", "plain", "default")


def dispatch_engines(reg, dev):
    """Three engines alike but for stage 1: ``fanout_fn=make_fanout()``
    (the dispatch kernel), ``make_fanout(use_kernel=False)`` (its plain
    version on the card) and the default ``fanout_reference``; every
    other kernel on in all three."""
    from repro_torch.core import create_engine
    from repro_torch.kernels.stream_dispatch.ops import make_fanout
    fns = {"kernel": make_fanout(), "plain": make_fanout(use_kernel=False)}
    return {k: create_engine(reg, device=dev, **(
        {"fanout_fn": fns[k]} if k in fns else {})) for k in FANOUTS}


def drive_steps(torch, eng, sources, n_steps, K, seed, superstep):
    """``n_steps`` groups of K x batch posts to random sources (repeats
    included, so bursts carry over), each followed by one superstep of K
    rounds or by K eager rounds.  Returns every round's sink as host
    arrays, the raw spools (supersteps only) and the wall seconds."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B = eng.cfg.batch
    sinks, spools = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(n_steps):
        picks = rng.integers(0, len(sources), K * B)
        vals = rng.standard_normal((K * B, 4)).astype(np.float32)
        ts = s * 100 + rng.integers(0, 90, K * B)
        for j, v, t in zip(picks, vals, ts):
            eng.post(sources[j], v.tolist(), int(t))
        if superstep:
            spool = eng.superstep(K)
            spools.append(tuple(spool))
            sinks += [host_sink(x) for x in eng.spool_sinks(spool)]
        else:
            sinks += [tuple(eng.round()) for _ in range(K)]
    torch.cuda.synchronize()
    return sinks, spools, time.perf_counter() - t0


def dispatch_run(torch, dev, tag, reg, path, counters, run, per_round):
    """Build the three engines of :func:`dispatch_engines` on ``reg`` and
    run ``run(engine) -> (sinks, spools, ms per round)`` on each, the kernel
    engine last with every launch counter 0 just before it; the kernel
    engine must equal the other two bitwise (every state leaf, stat, DLQ
    entry, sink and spool) and ``stream_dispatch`` must have launched
    ``per_round`` times per round.  Returns (kernel engine, its sinks,
    launches, rounds)."""
    engines = dispatch_engines(reg, dev)
    for k, e in engines.items():
        if e._path != path:
            fail(f"{tag}: the {k} engine took the {e._path} path")
    out = {}
    for k in ("plain", "default", "kernel"):
        if k == "kernel":
            for c in counters:
                c.launches = 0
        out[k] = run(engines[k])
    launches = {c.__name__: c.launches for c in counters}
    sinks, spools, _ = out["kernel"]
    rounds = len(sinks)
    for k in ("plain", "default"):
        if len(out[k][0]) != rounds:
            fail(f"{tag}: {k} ran {len(out[k][0])} rounds, kernel {rounds}")
        compare_engines(f"{tag} kernel vs {k}", engines["kernel"], sinks,
                        engines[k], out[k][0])
        for i, (x, y) in enumerate(zip(spools, out[k][1])):
            compare(f"{tag} kernel vs {k} spool {i}", x, y)
    n = launches["stream_dispatch_call"]
    if n != per_round * rounds:
        fail(f"{tag}: stream_dispatch launched {n} times in {rounds} rounds "
             f"(want {per_round} a round)")
    c = engines["kernel"].counters()
    if c["emitted"] == 0:
        fail(f"{tag}: the run emitted nothing")
    per = ", ".join(f"{k} {out[k][2]}" for k in FANOUTS)
    print(f"[dispatch] {tag}: {rounds} rounds, kernel fan-out bitwise equal "
          f"to its plain version and to fanout_reference (every state "
          f"leaf, stat, DLQ entry, sink" + (", spool" if spools else "")
          + f"); launches {launches}; ms/round by fan-out (run in the "
          f"order plain, default, kernel): {per}; "
          f"processed={c['processed']} emitted={c['emitted']}", flush=True)
    return engines["kernel"], sinks, launches, rounds


def phase_dispatch(torch, dev, reg_staged, reg_fused, sources, counters,
                   rounds=16, K=8, n_steps=2, heavy=16, staged_heavy=4):
    """The engine with ``fanout_fn=make_fanout()`` on the paths that call
    it: single-device staged rounds (phase 5's registry: the ``tanh``
    composite forces the staged path); staged supersteps of K, their K
    rounds under the sync debug mode and equal to K eager rounds; heavy
    4-shard fused rounds (one ``stream_dispatch`` per shard against the
    shard's out-table and the global timestamps, and one
    ``by_sid_snapshot`` of the by-sid values and timestamps); a few heavy
    4-shard staged rounds.  Returns the launches of each path's kernel run and
    the kernel engines of the single staged and 4-shard fused runs."""
    B = reg_staged.cfg.batch

    def rounds_run(n, seed, warm):
        def run(e):
            sinks, secs = drive(torch, e, sources, n, seed, B, warm)
            return sinks, [], secs / (n - warm) * 1e3
        return run

    def steps_run(e):
        guard_rounds(torch, e)
        sinks, spools, secs = drive_steps(torch, e, sources, n_steps, K,
                                          SEED + 22, True)
        return sinks, spools, secs / (n_steps * K) * 1e3

    out, kept = {}, {}
    kept["single staged"], _, out["single staged"], _ = dispatch_run(
        torch, dev, "single staged", reg_staged, "staged", counters,
        rounds_run(rounds, SEED + 21, 4), 1)
    e_step, s_step, launches, _ = dispatch_run(
        torch, dev, f"single staged supersteps K={K}", reg_staged, "staged",
        counters, steps_run, 1)
    out[f"single staged supersteps K={K}"] = launches
    e_round = dispatch_engines(reg_staged, dev)["kernel"]
    s_round, _, _ = drive_steps(torch, e_round, sources, n_steps, K,
                                SEED + 22, False)
    compare_engines(f"dispatch supersteps vs eager rounds", e_step, s_step,
                    e_round, s_round)
    print(f"[dispatch] single staged supersteps K={K}: every round of the "
          f"{n_steps} supersteps equal to {n_steps * K} eager rounds of the "
          f"kernel fan-out engine", flush=True)
    sharded = dict(n_shards=SHARDS, exchange_slots=0)
    for tag, reg, path, n, warm, seed in [
            (f"{SHARDS}-shard fused", reg_fused, "fused", heavy, 4,
             SEED + 23),
            (f"{SHARDS}-shard staged", reg_staged, "staged", staged_heavy, 0,
             SEED + 24)]:
        kept[tag], _, launches, n_rounds = dispatch_run(
            torch, dev, f"{tag} heavy", copy_registry(reg, **sharded), path,
            counters, rounds_run(n, seed, warm), SHARDS)
        if launches["by_sid_snapshot_call"] != n_rounds:
            fail(f"{tag}: by_sid_snapshot launched "
                 f"{launches['by_sid_snapshot_call']} times in {n_rounds} "
                 f"rounds")
        out[tag] = launches
    return out, kept


# --------------------------------------------------------------------------
# phase 13: timings at the main path's shapes
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


def vm_chain(progs, rows) -> int:
    """The apply's dependent chain on these items: the most non-NOP
    instructions in any item's program (``rows`` index ``progs``'s rows;
    an invalid item runs row 0's, as the kernel and its plain version
    do).  Each reads registers that earlier ones may have written, so the
    VM takes at least this many dependent instructions."""
    return int((progs[rows.long()][..., 0] != 0).sum(dim=-1).max())


def chain_terms(by, n_bytes, n_ops, chain_ms):
    """The three terms of ``bound_ms`` as printed beside a bound (``by``
    its verdict): bytes, operations at the scalar peak, and the dependent
    chain."""
    binds = "the chain" if by == "operations" and chain_ms >= \
        n_ops / SCALAR_OPS_PER_S * 1e3 else by
    return (f"terms: bytes {n_bytes / HBM_BYTES_PER_S * 1e3} ms, operations "
            f"{n_ops / SCALAR_OPS_PER_S * 1e3} ms, chain {chain_ms} ms; "
            f"{binds} binds")


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

    # both pops take the first B slots of one static order: a selection
    # over Q keys for each slot's within-tenant rank (its tag), and one for
    # the pick, each a compare tree of ceil(log2 Q) levels and one step
    # more; the step-by-step pop's chain, B such selections, is not the
    # function's
    levels = 2 * (math.ceil(math.log2(Q)) + 1)
    stepwise = B * (math.ceil(math.log2(Q)) + 1)
    chain = levels * dep_cycles / clock_hz * 1e3
    print(f"[bound] selection chain: {levels} dependent instructions x "
          f"{dep_cycles} cycles (probe) at the {clock_hz / 1e6} MHz maximum "
          f"SM clock = {chain} ms (the step-by-step pop's chain: {stepwise} "
          f"instructions, {stepwise * dep_cycles / clock_hz * 1e3} ms)",
          flush=True)

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
    # the apply waits for the pop: their chains add
    fr_vm = vm_chain(tb.progs, torch.clamp(out[2], 0, cfg.n_streams - 1))
    fr_chain = chain + fr_vm * dep_cycles / clock_hz * 1e3
    fr_bound, fr_by = bound_ms(fr_bytes, B * Q, fr_chain)
    fr_terms = chain_terms(fr_by, fr_bytes, B * Q, fr_chain)
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
          f"bound {fr_bound} ms ({fr_by}; {fr_bytes} bytes; chain: the "
          f"pop's {levels} + the VM's {fr_vm} dependent instructions, the "
          f"longest non-NOP program among the items, x {dep_cycles} cycles; "
          f"{fr_terms}); programs of {tb.progs.shape[-2]} steps; "
          f"{n_valid}/{B * F} valid work items", flush=True)
    return rows_out


def record_plans(torch, eng, sources, module, names):
    """One more heavy round of ``eng`` with the arguments of the first
    call of each ``module.plan_<name>`` recorded: the main path's inputs,
    for timing the kernels alone.  Returns ``{name: (args, kwargs)}``."""
    rec, orig = {}, {n: getattr(module, f"plan_{n}") for n in names}

    def recorder(name):
        def plan(*a, **kw):
            rec.setdefault(name, (a, kw))
            return orig[name](*a, **kw)
        return plan

    for n in names:
        setattr(module, f"plan_{n}", recorder(n))
    try:
        drive(torch, eng, sources, 1, SEED + 13, eng.cfg.batch)
    finally:
        for n in names:
            setattr(module, f"plan_{n}", orig[n])
    if len(rec) != len(names):
        fail(f"the round did not reach every kernel of {names}: {list(rec)}")
    return rec


def apply_cost(torch, args):
    """Bytes and operations the sharded apply needs on these inputs, as
    ``fused_round_bytes`` reckons them, with the two row spaces apart:
    per shard, for every distinct table row an item lands on its in_table
    row, flags, program up to its last non-NOP instruction and the
    constants its CONST instructions read; once for all shards, the value
    and timestamp of every distinct snapshot row read (targets and
    fetched co-inputs; the trigger slot comes with the item); every item's
    inputs and outputs once.  Operations: the VM instructions each item
    runs (its row's non-NOP instructions)."""
    from repro_torch.core.program import OP_CONST
    (_layout, in_table, progs, consts, _comp, _act, rows, t_sid, wi_src,
     wi_vals, _ts, _valid, values, _tstamp) = args
    S, W = rows.shape
    M, L, K, C = in_table.shape[-1], progs.shape[-2], consts.shape[-1], \
        wi_vals.shape[-1]
    n_snap = values.shape[0]
    dev = rows.device
    n = S * W * (4 + 4 + 1 + 4 + 4 + 4 * C) + S * W * (4 * C + 4 + 5)
    steps = torch.arange(1, L + 1, device=dev)
    snap, ops = [], 0
    for s in range(S):
        r = rows[s].long()
        u = r.unique()
        n += u.numel() * (M * 4 + 2)
        pr = progs[s][u]
        l_eff = torch.where(pr[..., 0] != 0, steps, 0).max(dim=1).values
        n += 16 * int(l_eff.sum())
        a = pr[..., 2]
        a = torch.clamp(torch.where(a < 0, a + K, a), 0, K - 1)
        const = (pr[..., 0] == OP_CONST) & (steps[None, :] <= l_eff[:, None])
        n += 4 * (u[:, None] * K + a)[const].unique().numel()
        ops += int((progs[s][r][..., 0] != 0).sum())
        in_rows = in_table[s][r]
        hit = (in_rows >= 0) & (in_rows == wi_src[s][:, None])
        trig = torch.where(hit.any(dim=1), hit.int().argmax(dim=1), 0)
        fetch = (in_rows >= 0) & (
            torch.arange(M, device=dev)[None, :] != trig[:, None])
        snap += [t_sid[s].long(),
                 torch.clamp(in_rows[fetch], 0, n_snap - 1).long()]
    n += torch.cat(snap).unique().numel() * (4 * C + 4)
    return n, ops


def time_shard_kernels(torch, eng, sources, errs, launches, dep_cycles,
                       clock_hz):
    """``exchange_compact`` and ``apply_programs`` at the sharded main
    path's shapes and data (recorded from one round of the kernel
    engine), timed alone beside their plain versions and bounds."""
    from repro_torch.kernels.round_fuse.kernel import (plan_apply_programs,
                                                       plan_exchange_compact)
    from repro_torch.kernels.round_fuse.ops import (apply_programs,
                                                    exchange_compact)
    from repro_torch.kernels.round_fuse import kernel as K
    rec = {k: a for k, (a, _) in record_plans(
        torch, eng, sources, K, ("apply_programs", "exchange_compact")).items()}
    rows = []
    xa = rec["exchange_compact"]
    D, E = xa[6], xa[7]
    S, W = xa[0].shape
    C = xa[4].shape[-1]
    x_bytes = S * W * (5 * 4 + 4 * C + 1) + S * D * E * (4 + C) * 4
    x_bound, x_by = bound_ms(x_bytes, 0, 0.0)
    launch, _ = plan_exchange_compact(*xa)
    ms, ev, host, prof, src = launch_ms(launch, "exchange_compact_kernel")
    plain = time_ms(lambda: exchange_compact(*xa, use_kernel=False), reps=5)
    routed = int((xa[5] < D).sum())
    rows.append(dict(
        name="exchange_compact", route="cuda",
        source="src/repro_torch/kernels/round_fuse/csrc/exchange_compact.cu",
        replaces="src/repro/kernels/round_fuse/kernel.py:549",
        launches=launches["exchange_compact_call"],
        max_abs_err=errs["exchange_compact"], ms=ms, plain_ms=plain,
        bound_ms=x_bound, bound_by=x_by, library_ms=None))
    print(f"[timing] exchange_compact at ({S} senders, W={W}, {D} x {E} "
          f"slots, C={C}), {routed} routed items: kernel {ms} ms ({src}; "
          f"CUDA events over 200 back-to-back launches {ev} ms, host "
          f"enqueue {host} ms per launch, profiler {prof} ms); "
          f"plain {plain} ms; bound {x_bound} ms ({x_by}; {x_bytes} bytes: "
          f"W x (5 int32 + C f32 + drop byte) in and out, D x E x (4 + C) "
          f"x 4 B of buckets out, per sender); no single PyTorch call ranks "
          f"items per destination and scatters them, so no library time",
          flush=True)
    aa = rec["apply_programs"]
    a_bytes, a_ops = apply_cost(torch, aa)
    a_vm = max(vm_chain(aa[2][s], aa[6][s]) for s in range(aa[6].shape[0]))
    a_chain = a_vm * dep_cycles / clock_hz * 1e3
    a_bound, a_by = bound_ms(a_bytes, a_ops, a_chain)
    a_terms = chain_terms(a_by, a_bytes, a_ops, a_chain)
    launch, _ = plan_apply_programs(*aa)
    ms, ev, host, prof, src = launch_ms(launch, "apply_programs_kernel")
    plain = time_ms(lambda: apply_programs(*aa, use_kernel=False), reps=3)
    S, W = aa[6].shape
    rows.append(dict(
        name="apply_programs", route="cuda",
        source="src/repro_torch/kernels/round_fuse/csrc/fused_round.cu",
        replaces="src/repro/kernels/round_fuse/kernel.py:463",
        launches=launches["apply_programs_call"],
        max_abs_err=errs["apply_programs"], ms=ms, plain_ms=plain,
        bound_ms=a_bound, bound_by=a_by, library_ms=None))
    print(f"[timing] apply_programs at ({S} shards x {W} items, "
          f"{aa[1].shape[1]} table rows, {aa[12].shape[0]} snapshot rows), "
          f"{int(aa[11].sum())} valid items: kernel {ms} ms ({src}; CUDA "
          f"events over 200 back-to-back launches {ev} ms, host enqueue "
          f"{host} ms per launch, profiler {prof} ms); plain "
          f"{plain} ms; bound {a_bound} ms ({a_by}; {a_bytes} bytes, {a_ops} "
          f"VM instructions, a chain of {a_vm} dependent instructions (the "
          f"longest non-NOP program among the items) x {dep_cycles} "
          f"cycles at {clock_hz / 1e6} MHz; {a_terms}); programs of "
          f"{aa[2].shape[-2]} steps; no single PyTorch call runs the "
          f"bytecode VM, so no library time", flush=True)
    return rows


def gather_bytes(ids, n_rows: int, F: int, ok=None) -> int:
    """Bytes a row gather must move on these ids: each id once, each
    distinct row read once (only ids in range and, where ``ok`` is given,
    marked), each output element once."""
    take = (ids >= 0) & (ids < n_rows)
    if ok is not None:
        take &= ok
    rows = ids[take].unique().numel()
    return ids.numel() * 4 + rows * F * 4 + ids.numel() * F * 4


def launch_ms(launch, name: str):
    """Device ms per call of ``launch`` (a kernel named ``name``; "" sums
    every kernel the call runs).  CUDA events around 200 back-to-back
    calls measure the host's enqueue rate once that is the slower of the
    two, so then the profiler's device time is taken.  Returns (ms, event
    ms, host enqueue ms, profiler ms, which of the two was taken)."""
    ev, host = time_launches([launch], 200)
    prof = profile_kernels([launch], [name])[name]
    if prof is not None and host >= ev:
        return prof, ev, host, prof, "profiler"
    return ev, ev, host, prof, "events"


def time_dispatch_kernels(torch, e_single, e_shard, sources, errs,
                          launches, probe_lib):
    """``stream_dispatch`` at the single staged round's shape and at the
    4-shard round's, and the by-sid snapshot (``onehot_gather_kernel``
    through ``by_sid_snapshot``) at the 4-shard round's (inputs recorded
    from one round of phase 12's kernel engines), timed alone beside
    their plain versions, bounds and ``torch.index_select`` of the same
    rows (the nearest single PyTorch call; it does no masking).  Both
    kernels are far shorter than a launch from the host: their times and
    the library call's are device times (``launch_ms``).  Then their
    launch floor: an empty kernel in one profiler window with
    ``exchange_compact``, the snapshot and ``stream_dispatch`` at the
    4-shard round's inputs."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.round_fuse import kernel as RF
    from repro_torch.kernels.stream_dispatch import kernel as K
    from repro_torch.kernels.stream_dispatch.ops import (by_sid_snapshot,
                                                         stream_dispatch)
    plan_sd, plan_snap = K.plan_stream_dispatch, K.plan_by_sid_snapshot

    def report(tag, name, kernel, launch, plain_fn, lib_fn, n_bytes, what,
               lib_what):
        ms, ev, host, prof, src = launch_ms(launch, f"{kernel}_kernel")
        lib, lib_ev, lib_host, _, lib_src = launch_ms(lib_fn, "")
        plain = time_ms(plain_fn, reps=20)
        bound, by = bound_ms(n_bytes, 0, 0.0)
        print(f"[timing] {name} at {tag}: kernel {ms} ms ({src}; CUDA "
              f"events over 200 back-to-back launches {ev} ms, host enqueue "
              f"{host} ms per launch, profiler {prof} ms); plain {plain} "
              f"ms; {lib_what} {lib} ms ({lib_src}; events {lib_ev} ms, host "
              f"{lib_host} ms; no masking); bound {bound} ms ({by}; "
              f"{n_bytes} bytes: {what})", flush=True)
        return dict(name=kernel, route="cuda",
                    source="src/repro_torch/kernels/stream_dispatch/csrc/"
                           "stream_dispatch.cu",
                    launches=launches[kernel],
                    max_abs_err=errs[kernel], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib)

    rows, floor_launches = [], {}
    for tag, eng in (("single staged", e_single),
                     (f"{SHARDS}-shard", e_shard)):
        rec = record_plans(torch, eng, sources, K,
                           ("stream_dispatch",) if eng is e_single else
                           ("stream_dispatch", "by_sid_snapshot"))
        a, kw = rec["stream_dispatch"]
        sid, ts, valid, out_table, tstab = a
        n_tab, F = out_table.shape
        idx = torch.clamp(sid, 0, n_tab - 1).long()
        sd_launch = plan_sd(*a, **kw)[0]
        row = report(
            f"the {tag} round's shape ({sid.shape[0]} events, {int(valid.sum())} "
            f"valid, ({n_tab}, {F}) out-table, {tstab.shape[0]} timestamps, "
            f"with_early={kw.get('with_early', True)})", "stream_dispatch",
            "stream_dispatch", sd_launch,
            lambda: stream_dispatch(*a, **kw, use_kernel=False),
            lambda: torch.index_select(out_table, 0, idx),
            gather_bytes(sid, n_tab, F, valid) + sid.shape[0],
            "sid and valid flag per event, the valid events' out-table "
            "rows, the targets", "torch.index_select of the same rows")
        if not rows:
            rows.append(dict(row, replaces="src/repro/kernels/"
                             "stream_dispatch/ops.py:29"))
        if eng is e_single:
            continue
        floor_launches["stream_dispatch"] = sd_launch
        vals, stamps, ids = rec["by_sid_snapshot"][0]
        S, (L, C) = len(vals), vals[0].shape
        stacked = torch.stack(list(vals)).reshape(S * L, C)
        lidx = ids.long()
        snap_launch = plan_snap(vals, stamps, ids)[0]
        floor_launches["onehot_gather"] = snap_launch
        rows.append(dict(report(
            f"the {SHARDS}-shard snapshot's shape ({S} shards of ({L}, {C}) "
            f"values and ({L},) timestamps, {ids.shape[0]} ids; one "
            f"launch, by_sid_snapshot)", "by_sid_snapshot", "onehot_gather",
            snap_launch,
            lambda: by_sid_snapshot(vals, stamps, ids, use_kernel=False),
            lambda: torch.index_select(stacked, 0, lidx),
            gather_bytes(ids, S * L, C + 1),
            "the ids, each distinct row's values and timestamp, both "
            "outputs", "torch.index_select of the same value rows from a "
            "stacked table made beforehand (values only)"),
            replaces="src/repro/kernels/stream_dispatch/kernel.py:41"))
    (xa, _), = record_plans(torch, e_shard, sources, RF,
                            ("exchange_compact",)).values()
    floor_launches["exchange_compact"] = RF.plan_exchange_compact(*xa)[0]
    probe = ctypes.CDLL(str(probe_lib))
    probe.empty_launch.argtypes = [ctypes.c_void_p]
    stream = _build.stream_ptr(torch.device("cuda", 0))

    def empty():
        if probe.empty_launch(stream):
            fail("the empty kernel did not launch")

    e_ev, e_host = time_launches([empty], 200)
    names = ["empty_kernel", *(f"{k}_kernel" for k in floor_launches)]
    prof = profile_kernels([empty, *floor_launches.values()], names)
    floor = prof["empty_kernel"]
    if any(prof[k] is None for k in names):
        fail(f"the launch-floor window missed a kernel: {prof}")
    print(f"[timing] launch floor ({SHARDS}-shard round's inputs, one "
          f"profiler window of 50 rounds of {len(names)} launches): empty "
          f"kernel {floor} ms device (CUDA events over 200 back-to-back "
          f"launches {e_ev} ms, host enqueue {e_host} ms per launch); "
          + "; ".join(f"{k} {prof[f'{k}_kernel']} ms = "
                      f"{prof[f'{k}_kernel'] / floor} x the floor"
                      for k in floor_launches), flush=True)
    return rows


def window_agg_cost(count, N: int, C: int):
    """Bytes and operations the window aggregates need: each valid entry
    read once (the kernel loads no entry past a stream's count), the
    counts, and five (N, C) outputs written; three float operations per
    valid value (add, max, min) and one division per output mean."""
    valid = int(count.clamp(min=0).sum())
    return valid * C * 4 + N * 4 + 5 * N * C * 4, 3 * valid * C + N * C


WINDOW_PREDICTION = {      # written before the redesign's first timed run
    "suite": (0.003, 0.006), "full": (0.025, 0.045)}


def time_window_agg(torch, suite, errs, launches):
    """``window_agg`` at the suite's store (the main path's shape and
    counts) and at (4096, 1024, 4) with every window full (64 MB, more
    than the 50 MB L2, so the kernel reads HBM), each on the aligned
    store (bulk copies) and on a view one float into its buffer (4-byte
    copies), beside the prediction."""
    from repro_torch.kernels.window_agg.kernel import plan_window_agg
    from repro_torch.kernels.window_agg.ops import window_agg
    store = suite.stats.store
    N, W, C = store.values.shape
    count = torch.clamp(store.total, max=W)
    gen = torch.Generator(device=store.values.device).manual_seed(SEED)
    big = torch.randn((4096, 1024, 4), generator=gen,
                      device=store.values.device)
    full = torch.full((4096,), 1024, dtype=torch.int32, device=big.device)
    out = {}
    for tag, vals, cnt in (("suite", store.values, count),
                           ("full", big, full)):
        n_bytes, n_ops = window_agg_cost(cnt, *vals.shape[::2])
        bound, by = bound_ms(n_bytes, n_ops, 0.0)
        times = {}
        for store_v in (vals, offset_view(torch, vals)):
            launch, _ = plan_window_agg(store_v, cnt)
            times[launch.plan.staging] = launch_ms(launch,
                                                   "window_agg_kernel")
        plain = time_ms(lambda: window_agg(vals, cnt, use_kernel=False),
                        reps=5 if tag == "suite" else 3)
        lo, hi = WINDOW_PREDICTION[tag]
        own = next(iter(times.values()))        # the plan's own staging
        where = "the suite's" if tag == "suite" else "every window full,"
        print(f"[timing] window_agg at {where} {tuple(vals.shape)}, "
              f"{int(cnt.sum())} valid entries: "
              + "; ".join(f"{k} staging {v[0]} ms ({v[4]}; CUDA events "
                          f"over 200 back-to-back launches {v[1]} ms, host "
                          f"enqueue {v[2]} ms per launch, profiler {v[3]} "
                          f"ms)" for k, v in times.items())
              + f"; predicted {lo}-{hi} ms; plain {plain} ms; bound {bound} "
              f"ms ({by}; {n_bytes} bytes this data needs; {n_ops} "
              f"operations) = {n_bytes / (own[0] * 1e-3) / 1e12} TB/s "
              f"achieved on the plan's staging; no single PyTorch call "
              f"computes the five aggregates, so no library time",
              flush=True)
        out[tag] = (own[0], plain, bound, by)
    ms, plain, bound, by = out["suite"]
    return dict(
        name="window_agg", route="cuda",
        source="src/repro_torch/kernels/window_agg/csrc/window_agg.cu",
        replaces="src/repro/kernels/window_agg/kernel.py:38",
        launches=launches, max_abs_err=errs["window_agg"], ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)


# --------------------------------------------------------------------------
# phases 14-17: the model plane's prefill (gemma3-1b, jamba-v0.1-52b)
# --------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12      # H100 SXM tensor cores, dense bf16 (data sheet)
PROMPT = 4096                # prompt tokens per sequence
# (arch, layers kept, batch): gemma3-1b at its published depth; jamba at
# one period of its 32 layers (8 layers with every layer kind: Mamba,
# attention, dense and MoE MLPs) because the 32 layers' 52 B parameters
# (~104 GB in bf16) exceed the card's 80 GB; widths as published
PREFILL_MODELS = (("gemma3-1b", None, 2), ("jamba-v0.1-52b", 8, 1))
PREFILL_SEEDS = (SEED, SEED + 1, SEED + 2)   # weights and prompts, bf16 gate
FA_SWEEP = ((1, 2, 2, 128, 64, None), (2, 4, 2, 256, 128, None),
            (1, 4, 1, 256, 64, 64), (2, 2, 2, 128, 32, 32),
            (1, 8, 4, 128, 64, None),             # tests/test_kernels.py:80
            (2, 4, 1, 77, 256, 13), (1, 3, 1, 1, 16, None),
            (1, 4, 2, 200, 24, None))             # odd lengths and widths
# full-width attention layers (tag, B, H, KV, L, Dh, window): GQA groups
# H / KV of 4, 2, 1, 4, 12, 1 (Dh 64) and 8 besides gemma3-1b's 4 at Dh 256
FA_FULL = (("gemma3-1b local", 2, 4, 1, PROMPT, 256, 512),
           ("gemma3-1b global", 2, 4, 1, PROMPT, 256, None),
           ("jamba-v0.1-52b", 1, 32, 8, PROMPT, 128, None),
           ("gemma3-27b local", 1, 32, 16, PROMPT, 128, 1024),
           ("gemma3-27b global", 1, 32, 16, PROMPT, 128, None),
           ("deepseek-moe-16b", 1, 16, 16, PROMPT, 128, None),
           ("minitron-8b", 1, 32, 8, PROMPT, 128, None),
           ("mistral-large-123b", 1, 96, 8, PROMPT, 128, None),
           ("musicgen-large", 1, 32, 32, PROMPT, 64, None),
           ("qwen2-vl-72b", 1, 64, 8, PROMPT, 128, None))
# the layers phase 17 times
FA_TIMED = ("gemma3-1b local", "gemma3-1b global", "jamba-v0.1-52b",
            "gemma3-27b local", "gemma3-27b global", "mistral-large-123b",
            "musicgen-large")
SCAN_SWEEP = ((1, 16, 32, 8), (2, 64, 128, 16), (1, 128, 256, 16),  # :103
              (2, 37, 40, 4), (1, 300, 96, 32),  # odd lengths, other S
              (1, PROMPT, 8192, 16),             # jamba's Mamba layer
              (2, 33, 8200, 16))                 # 2 KB ring rows


def scan_sweep():
    """SCAN_SWEEP, then both paths and both templates: B 4 with a carried
    state, L around one ring chunk of T steps and long, every S, Di 333
    (no multiple of any CTA's channels)."""
    from repro_torch.kernels.selective_scan.kernel import RING_STEPS as T
    return SCAN_SWEEP + tuple((4, L, 333, S)
                              for L in (1, 2, T - 1, T, T + 1, 300)
                              for S in (1, 2, 4, 8, 16, 32))


# on views one float into their buffers: the one-state template
SCAN_UNALIGNED = ((4, 1, 8192, 16), (4, 300, 333, 16))
SCAN_LAYER = (1, PROMPT, 8192, 16)       # jamba's Mamba layer (phase 17)


def close_or_fail(name, got, want, tol, atol=None) -> float:
    """Fail unless ``got`` is finite and within ``atol`` + ``tol`` *
    |want| of ``want`` (``atol`` = ``tol`` unless given, as
    ``tests/test_kernels.py``); return the max absolute difference."""
    import torch
    atol = tol if atol is None else atol
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        fail(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
             "non-finite output")
    d = (g - w).abs()
    bad = int((d > atol + tol * w.abs()).sum())
    if bad:
        fail(f"{name}: {bad} of {d.numel()} elements differ from the plain "
             f"version by more than {atol} + {tol} |plain| (max |diff| "
             f"{d.max().item()})")
    return d.max().item()


def fa_inputs(torch, gen, B, H, KV, L, Dh, dtype, transposed=False):
    """(B, L, H, Dh) q and (B, L, KV, Dh) k, v ~ N(0, 1); ``transposed``
    makes them transposed views of (B, H, L, Dh) and (B, KV, L, Dh)
    tensors, the layout of the JAX kernel and its tests."""
    shapes = (((B, H, L, Dh), (B, KV, L, Dh)) if transposed
              else ((B, L, H, Dh), (B, L, KV, Dh)))
    out = [torch.randn(sh, generator=gen, device=gen.device).to(dtype)
           for sh in (shapes[0], shapes[1], shapes[1])]
    return [t.transpose(1, 2) for t in out] if transposed else out


def scan_inputs(torch, gen, B, L, Di, S):
    """a = exp(-|N|) in (0, 1] as a discretised decay, bx, c, h0 ~ N."""
    dev = gen.device
    a = torch.randn((B, L, Di, S), generator=gen, device=dev).abs_().neg_().exp_()
    return [a] + [torch.randn(sh, generator=gen, device=dev)
                  for sh in ((B, L, Di, S), (B, L, S), (B, Di, S))]


SCAN_NAME = "selective_scan_"   # both kernels' names start so (profiler)


def scan_plan_text(plan) -> str:
    """A selective_scan plan as a phrase: path, template and CTA shape."""
    return (f"{plan.path} path, {plan.states} states a thread, "
            f"{plan.grid[0] * plan.grid[1]} CTAs of {plan.threads} threads "
            f"({plan.channels} channels each), {plan.smem_bytes} dynamic "
            f"shared bytes")


def scan_cost(B, L, Di, S):
    """Bytes (a, bx, c, h0 read once; y and the final state written once)
    and operations (a multiply and an add for h, a multiply and an add for
    y, per (b, t, d, s)) of one selective scan."""
    return ((2 * B * L * Di * S + B * L * S + 2 * B * Di * S + B * L * Di)
            * 4, 4 * B * L * Di * S)


def scan_check(torch, tag, args):
    """selective_scan through the kernel against its plain version within
    1e-4; returns (max |diff|, the launch's plan)."""
    from repro_torch.kernels.selective_scan.kernel import plan_selective_scan
    from repro_torch.kernels.selective_scan.ops import selective_scan
    plan = plan_selective_scan(*args)[0].plan
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    wy, wh = selective_scan(*args, use_kernel=False)
    return max(close_or_fail(f"selective_scan y {tag}", y, wy, 1e-4),
               close_or_fail(f"selective_scan h {tag}", h, wh, 1e-4)), plan


def phase_model_kernels(torch, dev):
    """Both model kernels against their plain versions on the card:
    attention at the sweep of tests/test_kernels.py and odd shapes
    (transposed views; float32 2e-5, bf16 2e-2) and at the slice's
    full-width layers (the model's layout; float32 2e-5, bf16 one unit in
    the last place: 2^-7 |plain| + 1e-5); the scan at its sweep, odd
    shapes, jamba's layer, both paths and both templates (1e-4)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"flash_attention": 0.0, "selective_scan": 0.0}
    cases = [(f"sweep {c}", True, *c) for c in FA_SWEEP] + \
        [(tag, False, *c) for tag, *c in FA_FULL]
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for tag, transposed, B, H, KV, L, Dh, win in cases:
            q, k, v = fa_inputs(torch, gen, B, H, KV, L, Dh, dtype,
                                transposed)
            got = flash_attention_blhd(q, k, v, window=win)
            torch.cuda.synchronize()
            want = flash_attention_blhd(q, k, v, window=win,
                                        use_kernel=False)
            if got.dtype != dtype:
                fail(f"flash_attention {tag}: {got.dtype} out for {dtype} in")
            tol, atol = ((2 ** -7, 1e-5) if bf16 and not transposed else
                         (2e-2 if bf16 else 2e-5, None))
            errs["flash_attention"] = max(errs["flash_attention"], close_or_fail(
                f"flash_attention {tag} {dtype}", got, want, tol, atol))
        print(f"[model kernels] flash_attention == plain in {dtype} on "
              f"{len(FA_SWEEP)} shapes of the tests/test_kernels.py sweep "
              f"and odd lengths and widths (transposed views) within "
              f"{2e-2 if bf16 else 2e-5}, and at full width "
              f"({', '.join(t for t, *_ in FA_FULL)}; the model's layout) "
              f"within {'2^-7 |plain| + 1e-5' if bf16 else 2e-5}; max "
              f"|diff| so far {errs['flash_attention']}", flush=True)
    reached, sweep = {}, scan_sweep()
    for shape in sweep:
        args = scan_inputs(torch, gen, *shape)
        err, plan = scan_check(torch, shape, args)
        errs["selective_scan"] = max(errs["selective_scan"], err)
        reached.setdefault((plan.path, plan.states), []).append(shape)
        del args
    for shape in SCAN_UNALIGNED:
        args = [offset_view(torch, t) for t in scan_inputs(torch, gen, *shape)]
        err, plan = scan_check(torch, f"{shape} one float into its buffer",
                               args)
        if plan.states != 1:
            fail(f"selective_scan on views one float into their buffers "
                 f"planned {plan}: expected the one-state template")
        errs["selective_scan"] = max(errs["selective_scan"], err)
        reached.setdefault((plan.path, plan.states), []).append(
            f"{shape} unaligned")
        del args
    if set(reached) != {("ring", 4), ("register", 4), ("register", 1)}:
        fail(f"selective_scan's sweep reached {sorted(reached)}: expected "
             "the ring and both register templates")
    print(f"[model kernels] selective_scan == plain within 1e-4 on "
          f"{len(sweep)} shapes (B, L, Di, S) and {len(SCAN_UNALIGNED)} "
          f"on views one float into their buffers; by path and states a "
          f"thread: " + "; ".join(f"{p} {v}: {len(c)} ({c[:3]}...)"
                                  for (p, v), c in sorted(reached.items()))
          + f"; max |diff| {errs['selective_scan']}", flush=True)
    torch.cuda.empty_cache()
    return errs


def leaves(tree, prefix=""):
    """(path, tensor) for every leaf of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def worst_leaf(name, got, want):
    """Fail on a non-finite leaf; return (max over leaves of
    max |got - want| / max |want|, that leaf's path)."""
    import torch
    worst = (0.0, "")
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not (bool(torch.isfinite(g).all())
                                      and bool(torch.isfinite(w).all())):
            fail(f"{name} {path}: shapes {tuple(g.shape)}/{tuple(w.shape)} "
                 "or non-finite values")
        r = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (r, path))
    return worst


def timed_prefill(torch, step, params, batch, reps):
    """``reps`` synchronised prefills after the one already run: (ms per
    prefill on the host clock, peak device bytes)."""
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(params, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, \
        torch.cuda.max_memory_allocated()


class RouteReplay:
    """Stands in for ``repro_torch.models.moe.topk_route`` while it is
    installed (``with``).  In mode "record" every call keeps the experts
    it chose.  In "replay", call i routes to the experts recorded at call
    i, with gates from this pass's own router probabilities at them; in
    "count" it keeps its own choice.  Both count the tokens whose own
    choice (the experts or their order) differs from the recorded one.
    Mode None passes through."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.topk_route
        self.mode, self.recorded = None, []
        self.calls = self.flips = self.tokens = 0

    def __enter__(self):
        self.moe.topk_route = self
        return self

    def __exit__(self, *exc):
        self.moe.topk_route = self.route

    def start(self, mode):
        if mode == "record":
            self.recorded = []
        self.mode = mode
        self.calls = self.flips = self.tokens = 0

    def __call__(self, logits, k, renorm):
        import torch
        gates, idx, probs = self.route(logits, k, renorm)
        if self.mode == "record":
            self.recorded.append(idx)
        elif self.mode in ("replay", "count"):
            kept = self.recorded[self.calls]
            self.calls += 1
            self.flips += int((idx != kept).any(-1).sum())
            self.tokens += idx[..., 0].numel()
            if self.mode == "replay":
                idx, gates = kept, probs.gather(-1, kept)
                if renorm:      # as topk_route renormalises its gates
                    gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                                min=1e-9)
        return gates, idx, probs

    def paired(self, step_k, step_p, params, batch, mode):
        """The kernel pass recording its routing, then the plain pass in
        ``mode``; returns both outputs and the tokens routed otherwise."""
        self.start("record")
        out_k = step_k(params, batch)
        self.start(mode)
        out_p = step_p(params, batch)
        if self.calls != len(self.recorded):
            fail(f"the plain pass routed {self.calls} times, the kernel "
                 f"pass {len(self.recorded)}")
        flips = f"{self.flips} of {self.tokens} tokens"
        self.start(None)
        return out_k, out_p, flips


def model_batch(torch, dev, cfg, B, L, seed):
    """B prompts of L positions from ``seed`` in the model's input: token
    ids (B, L), codebook ids (B, L, K) where the model has K > 1
    codebooks, or input embeddings (B, L, d_model) ~ N(0, 1) in the
    compute dtype where it takes embeddings (drawn on the card)."""
    import numpy as np
    if cfg.embed_inputs:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {"embeds": torch.randn((B, L, cfg.d_model), generator=gen,
                                      device=dev).to(cfg.cdtype)}
    shape = (B, L, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, L)
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, shape)).to(dev)}


def prefill_inputs(torch, dev, cfg, B, seed):
    """Weights (drawn on the card from ``seed`` leaf by leaf, each cast as
    ``cast_params`` casts it as soon as it is drawn) and a batch of B
    prompts of PROMPT positions from ``seed`` (``model_batch``)."""
    from repro_torch.models.model import cast_leaf, param_specs
    from repro_torch.models.params import init_params
    params = init_params(param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(seed), dev,
                         transform=lambda t: cast_leaf(cfg, t))
    return params, model_batch(torch, dev, cfg, B, PROMPT, seed)


def upcast(torch, params) -> None:
    """Every leaf of ``params`` to float32 in place, leaf by leaf (the
    bf16 copy of a leaf is freed before the next is made)."""
    for node_path in [path for path, _ in leaves(params)]:
        node = params
        *keys, last = node_path.split("/")
        for k in keys:
            node = node[k]
        node[last] = node[last].float()
    torch.cuda.empty_cache()


def bf16_gate(arch, seed, run, out_k, out_p, flips):
    """Fail unless every leaf of the bf16 kernel pass is within 0.1 of
    the leaf's max |plain|; print and return the worst ratio."""
    ratio, path = worst_leaf(arch, {"logits": out_k[0], "caches": out_k[1]},
                             {"logits": out_p[0], "caches": out_p[1]})
    if ratio > 0.1:
        fail(f"{arch} bf16 seed {seed} run {run}: kernels vs plain at "
             f"{path} read {ratio} of the leaf's max |plain|, above 0.1")
    print(f"[prefill] {arch} bf16 seed {seed} run {run}: kernels vs plain "
          f"(the plain pass on the kernel pass's experts; tokens whose own "
          f"routing differed: {flips}), worst leaf max |diff| / max |plain| "
          f"= {ratio} ({path}; gate 0.1)", flush=True)
    return ratio


def phase_prefill(torch, dev, arch, n_layers, B, counters):
    """One model's prefill at full width (``make_prefill_step``), bf16
    through the kernels and through their plain versions (the plain pass
    on the kernel pass's experts), twice for each of PREFILL_SEEDS, and
    float32 (the first seed's weights upcast, routing not replayed).
    Gates: the kernel launches of the counted run equal the layers of
    each kind; every leaf finite; the bf16 runs' logits and every cache
    leaf within 0.1 of the leaf's max |plain|, the float32 run's within
    1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import ATTN, ATTN_LOCAL, MAMBA
    from repro_torch.models.model import count_params, make_prefill_step
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    published = cfg.n_layers
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers).validate()
    kinds = [m for m, _ in cfg.layer_specs]
    want = {"flash_attention_call": sum(m in (ATTN, ATTN_LOCAL) for m in kinds),
            "selective_scan_call": sum(m == MAMBA for m in kinds)}
    t0 = time.perf_counter()
    params, batch = prefill_inputs(torch, dev, cfg, B, PREFILL_SEEDS[0])
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
    cut = (f"{cfg.n_layers} of the published {published} layers (one period:"
           f" every layer kind; all {published} exceed the card's memory)"
           if n_layers else f"{cfg.n_layers} layers, the published depth")
    print(f"[prefill] {arch}: {cut}, full width; {count_params(cfg)} "
          f"parameters ({n_bytes} bytes on the card, {cfg.compute_dtype}) "
          f"drawn in {time.perf_counter() - t0:.2f} s; B={B}, L={PROMPT}",
          flush=True)
    step_k = make_prefill_step(cfg)
    step_p = make_prefill_step(cfg, use_kernel=False)

    for c in counters:
        c.launches = 0
    out_k = step_k(params, batch)                 # the main path's run
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{arch}: {name} launched {launches[name]} times in one "
                 f"prefill, expected {n} (its layers)")
    n_leaves = len(list(leaves(out_k[1])))
    del out_k
    print(f"[prefill] {arch}: launches in the counted prefill "
          f"{ {k: launches[k] for k in want} } (layers of each kind: "
          f"{ {k: v for k, v in want.items()} }); logits and {n_leaves} "
          "cache leaves", flush=True)
    ms = {}
    for tag, step in (("kernels", step_k), ("plain", step_p)):
        step(params, batch)
        ms[tag], peak = timed_prefill(torch, step, params, batch, 3)
        print(f"[prefill] {arch} {tag}: {ms[tag]} ms per prefill (3 after "
              f"the first), {B * PROMPT / ms[tag] * 1e3} prompt tokens/s, "
              f"max_memory_allocated {peak} bytes", flush=True)

    ratios = []
    with RouteReplay() as replay:
        for i, seed in enumerate(PREFILL_SEEDS):
            if i:
                del params, batch
                torch.cuda.empty_cache()
                params, batch = prefill_inputs(torch, dev, cfg, B, seed)
            for run in (1, 2):
                out_k, out_p, flips = replay.paired(step_k, step_p, params,
                                                    batch, "replay")
                ratios.append(bf16_gate(arch, seed, run, out_k, out_p, flips))
                del out_k, out_p
        print(f"[prefill] {arch} bf16: worst leaf over {len(ratios)} runs "
              f"(seeds {list(PREFILL_SEEDS)}, two runs each) = "
              f"{max(ratios)} (gate 0.1)", flush=True)

        del params, batch
        torch.cuda.empty_cache()
        params, batch = prefill_inputs(torch, dev, cfg, B, PREFILL_SEEDS[0])
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        upcast(torch, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k, out_p, flips = replay.paired(
            make_prefill_step(cfg32), make_prefill_step(cfg32, use_kernel=False),
            params, batch, "count")
        torch.cuda.synchronize()
        ms["f32 pair"] = (time.perf_counter() - t0) * 1e3
    ratio, path = worst_leaf(arch, {"logits": out_k[0], "caches": out_k[1]},
                             {"logits": out_p[0], "caches": out_p[1]})
    if ratio > 1e-4:
        fail(f"{arch} float32: kernels vs plain at {path} read {ratio} of "
             "the leaf's max |plain|, above 1e-4")
    print(f"[prefill] {arch} in float32 (seed {PREFILL_SEEDS[0]}'s weights "
          f"upcast): kernels then plain in {ms['f32 pair']} ms (one run "
          f"each); each pass on its own experts (tokens routed otherwise: "
          f"{flips}); worst leaf max |diff| / max |plain| = {ratio} "
          f"({path}; gate 1e-4); {time.perf_counter() - t_phase:.1f} s in "
          "all", flush=True)
    del params, out_k, out_p
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


def attention_cost(B, H, KV, L, Dh, window, itemsize):
    """Bytes (q, k, v read once, o written once) and operations (a
    multiply and an add for each of q.k and p.v over Dh, per allowed
    (query, key) pair of the causal/window band) of one attention."""
    w = L if window is None else min(window, L)
    pairs = w * (w + 1) // 2 + (L - w) * w
    return (2 * B * L * H + 2 * B * L * KV) * Dh * itemsize, \
        4 * B * H * pairs * Dh


def device_ms(torch, launch, name, n):
    """(CUDA-event ms per launch over ``n`` back-to-back launches, host
    enqueue ms, profiler device ms); fails if the profiler does not see
    the kernel by its name in windows of 5, 20 and 50 launches (a short
    window's trace can come back without the launches' kernel events)."""
    ev, host = time_launches([launch], n, warmup=3)
    for window in (5, 20, 50):
        prof = profile_kernels([launch], [name], n=window)[name]
        if prof is not None:
            break
    if prof is None:
        fail(f"torch.profiler saw no CUDA kernel named {name}")
    return ev, host, prof


def graph_ms(torch, make_launch, n: int = 200) -> float:
    """CUDA-event ms a launch over ``n`` launches captured in one CUDA
    graph and replayed five times: the kernel's back-to-back device time
    with no host between launches (eager events read the host's enqueue
    rate once that is the slower).  ``make_launch()`` plans the launch on
    the capturing stream."""
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        launch = make_launch()
        launch()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(n):
            launch()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * n)


def time_model_kernels(torch, dev, errs, launches, fa_build, scan_build):
    """Both model kernels at the slice's shapes (random inputs of the
    main path's shapes, layout and dtype) beside their plain versions,
    their bounds, and for attention ``scaled_dot_product_attention``;
    attention's row carries every full-width layer and ``fa_build``
    (phase 1's report of the bf16 kernel), the scan's its plan and
    ``scan_build`` (phase 1's report of its templates)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import plan_flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
    from repro_torch.kernels.selective_scan.kernel import plan_selective_scan
    from repro_torch.kernels.selective_scan.ops import selective_scan
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, layers = [], {}
    for tag, B, H, KV, L, Dh, win in (c for c in FA_FULL
                                      if c[0] in FA_TIMED):
        q, k, v = fa_inputs(torch, gen, B, H, KV, L, Dh, torch.bfloat16)
        launch, _ = plan_flash_attention(q, k, v, window=win)
        ms, host, prof = device_ms(torch, launch, "flash_attention_wgmma_kernel",
                                   20)
        plain = time_ms(lambda: flash_attention_blhd(
            q, k, v, window=win, use_kernel=False), reps=5)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if win is not None:
            pos = torch.arange(L, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - win)
        lib, lib_host = time_launches([lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)], 20, warmup=3)
        n_bytes, n_ops = attention_cost(B, H, KV, L, Dh, win, 2)
        t_ops, t_bytes = n_ops / BF16_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        tflops = n_ops / (ms * 1e-3) / 1e12
        print(f"[timing] flash_attention at {tag} (B {B}, H {H}, KV {KV}, L "
              f"{L}, Dh {Dh}, window {win}, bf16, (B, L, H, Dh) layout): "
              f"kernel {ms} ms (CUDA events over 20 back-to-back launches; "
              f"host enqueue {host} ms), profiler {prof} ms; plain {plain} "
              f"ms; scaled_dot_product_attention {lib} ms (host {lib_host} "
              f"ms); bound {bound} ms ({by}; {n_ops} operations at the bf16 "
              f"tensor-core peak, {n_bytes} bytes) = {bound / ms} of the "
              f"bound; {tflops} TFLOP/s achieved (events; "
              f"{n_ops / (prof * 1e-3) / 1e12} by the profiler) on the "
              f"4 B H pairs Dh operations the function needs, the tensor "
              f"cores doing 1.5x that for the split probabilities", flush=True)
        layers[tag] = dict(ms=ms, profiler_ms=prof, plain_ms=plain,
                           library_ms=lib, bound_ms=bound, tflops=tflops)
        if tag == "gemma3-1b global":
            rows.append(dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:77",
                launches=launches["flash_attention_call"],
                max_abs_err=errs["flash_attention"], ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib, layers=layers,
                build=fa_build))
        del q, k, v, qh, kh, vh
    tag, B, H, KV, L, Dh, win = FA_FULL[2]
    q, k, v = fa_inputs(torch, gen, B, H, KV, L, Dh, torch.float32)
    launch, _ = plan_flash_attention(q, k, v, window=win)
    ms, host, prof = device_ms(torch, launch, "flash_attention_kernel", 20)
    print(f"[timing] flash_attention at {tag} in float32 (the float32 "
          f"prefill's inputs): kernel {ms} ms (CUDA events over 20 "
          f"back-to-back launches; host enqueue {host} ms), profiler {prof} "
          "ms", flush=True)
    del q, k, v
    B, L, Di, S = SCAN_LAYER
    args = scan_inputs(torch, gen, B, L, Di, S)
    launch, _ = plan_selective_scan(*args)
    ms, host, prof = device_ms(torch, launch, SCAN_NAME, 20)
    plain = time_ms(lambda: selective_scan(*args, use_kernel=False), reps=3)
    n_bytes, n_ops = scan_cost(B, L, Di, S)
    bound, by = bound_ms(n_bytes, n_ops, 0.0)
    print(f"[timing] selective_scan at jamba-v0.1-52b's Mamba layer (B {B}, "
          f"L {L}, Di {Di}, S {S}, float32; {scan_plan_text(launch.plan)}): "
          f"kernel {ms} ms (CUDA events over 20 back-to-back launches; host "
          f"enqueue {host} ms), profiler {prof} ms; plain {plain} ms; bound "
          f"{bound} ms ({by}; {n_bytes} bytes, {n_ops} operations) = "
          f"{bound / ms} of the bound by events, {bound / prof} by the "
          f"profiler; {n_bytes / (ms * 1e-3) / 1e12} TB/s achieved; no "
          f"single PyTorch call computes the recurrence, so no library time",
          flush=True)
    rows.append(dict(
        name="selective_scan", route="cuda",
        source="src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan/kernel.py:46",
        launches=launches["selective_scan_call"],
        max_abs_err=errs["selective_scan"], ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None, profiler_ms=prof,
        plan=launch.plan._asdict(), build=scan_build))
    return rows


# --------------------------------------------------------------------------
# phases 18-21: the xLSTM prefill (xlstm-1.3b) and mlstm_chunkwise
# --------------------------------------------------------------------------

XLSTM = "xlstm-1.3b"
XLSTM_BATCH = 2
# two of the published six periods (16 of 48 layers): every prefill of
# phases 19-20 spends most of its time in the sLSTM scans' host loop, one
# layer a period, so the phase's time follows the depth
XLSTM_LAYERS = 16
# (B, H, L, Dh, chunk, gates): the sweep of tests/test_kernels.py:119, then
# lengths no multiple of the chunk, Dh up to 1024, extreme gates, and full
# chunks of 256 rows after the first whose starting state still weighs
MLSTM_SWEEP = ((1, 2, 32, 16, 8, "normal"), (2, 2, 64, 32, 16, "normal"),
               (1, 4, 128, 64, 32, "normal"), (1, 1, 64, 128, 64, "normal"),
               (2, 3, 37, 16, 16, "normal"), (1, 2, 300, 128, 64, "normal"),
               (2, 1, 333, 1024, 256, "normal"),
               (1, 2, 96, 64, 32, "forget near 1"),
               (1, 2, 96, 64, 32, "forget near 0"),
               (1, 2, 96, 64, 32, "very negative i"),
               (1, 2, 640, 64, 256, "forget near 1"))
MLSTM_TOL = 3e-4             # tests/test_kernels.py:137


def mlstm_inputs(torch, gen, B, H, L, Dh, gates="normal", dtype=None):
    """q, k, v ~ N(0, 1) (in ``dtype``: bf16 for the bf16 prefill's
    inputs); i ~ N(0, 1), f ~ N(2, 1) as tests/test_kernels.py draws
    them, or gates pushed to an extreme."""
    dev = gen.device
    q, k, v = (torch.randn((B, H, L, Dh), generator=gen, device=dev).to(
        dtype or torch.float32) for _ in range(3))
    i = torch.randn((B, H, L), generator=gen, device=dev)
    f = torch.randn((B, H, L), generator=gen, device=dev) + 2
    if gates == "forget near 1":
        f += 6
    elif gates == "forget near 0":
        f -= 10
    elif gates == "very negative i":
        i -= 30
    return [q, k, v, i, f]


def mlstm_check(torch, tag, args, chunk):
    """G1: the kernel against the plain chunkwise version and against the
    float64 sequential oracle, each gated at MLSTM_TOL (atol + rtol
    |ref|).  Returns (max |kernel - plain|, kernel's and plain's max
    |diff| from the oracle)."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
    from repro_torch.kernels.mlstm_chunk.ref import init_mlstm_state, mlstm_ref
    B, H, L, Dh = args[0].shape
    h, st = mlstm_chunkwise(*args, chunk=chunk)
    torch.cuda.synchronize()
    wh, wst = mlstm_chunkwise(*args, chunk=chunk, use_kernel=False)
    err = 0.0
    for name, g, w in zip("hCnm", (h, *st), (wh, *wst)):
        err = max(err, close_or_fail(f"mlstm_chunkwise {tag} {name}", g, w,
                                     MLSTM_TOL))
    rh, rst = mlstm_ref(*args, *init_mlstm_state(B, H, Dh,
                                                 device=args[0].device))
    k_or = p_or = 0.0
    for name, g, w, r in zip("hCnm", (h, *st), (wh, *wst), (rh, *rst)):
        close_or_fail(f"mlstm_chunkwise {tag} {name} against the float64 "
                      "oracle", g, r.float(), MLSTM_TOL)
        k_or = max(k_or, (g.double() - r).abs().max().item())
        p_or = max(p_or, (w.double() - r).abs().max().item())
    return err, k_or, p_or


def phase_mlstm_kernel(torch, dev):
    """G1 on the sweep, for float32 and for bf16 q, k, v (which the plain
    version upcasts, so both see the same values): the kernel against its
    plain version and against the float64 oracle, both within MLSTM_TOL."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, L, Dh, ck, gates in MLSTM_SWEEP:
            case = (B, H, L, Dh, ck, gates, str(dtype)[6:])
            args = mlstm_inputs(torch, gen, B, H, L, Dh, gates, dtype)
            err, k_or, p_or = mlstm_check(torch, case, args, ck)
            errs.append(err)
            print(f"[mlstm] {case}: kernel vs plain max |diff| {err}; vs the "
                  f"float64 oracle: kernel {k_or}, plain {p_or} (gate "
                  f"{MLSTM_TOL} + {MLSTM_TOL} |ref| on both)", flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def nudge_up(torch, t):
    """Every element moved up by one unit in the last place (toward
    +inf), as numpy's nextafter, for float32 and bf16 alike."""
    idt = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype]
    bits = t.view(idt)
    up = torch.where(t > 0, bits + 1, torch.where(t < 0, bits - 1,
                                                  torch.ones_like(bits)))
    return up.view(t.dtype)


def leaf_ratios(name, got, want):
    """max |got - want| / max |want| per leaf of two trees (a prefill's
    (logits, caches) as ``logits`` and ``caches/...``); fails on a
    non-finite leaf or a shape mismatch."""
    import torch
    if isinstance(got, tuple):
        got, want = ({"logits": t[0], "caches": t[1]} for t in (got, want))
    out = {}
    for (path, g), (wpath, w) in zip(leaves(got), leaves(want)):
        g, w = g.double(), w.double()
        if path != wpath or g.shape != w.shape or not (
                bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
            fail(f"{name} {path}: shapes {tuple(g.shape)}/{tuple(w.shape)} or "
                 "non-finite values")
        out[path] = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    return out


class MlstmRecorder:
    """Stands in for ``repro_torch.models.xlstm.mlstm_chunkwise`` while it
    is installed (``with``) and keeps the arguments of its last call."""

    def __init__(self):
        from repro_torch.models import xlstm
        self.xlstm, self.fn, self.args = xlstm, xlstm.mlstm_chunkwise, None

    def __enter__(self):
        self.xlstm.mlstm_chunkwise = self
        return self

    def __exit__(self, *exc):
        self.xlstm.mlstm_chunkwise = self.fn

    def __call__(self, *args, **kw):
        self.args = args
        return self.fn(*args, **kw)


class ScanTimer:
    """Stands in for ``repro_torch.models.xlstm.slstm_scan`` while it is
    installed (``with``): each call synchronises the card before and
    after it and keeps its host-clock milliseconds."""

    def __init__(self):
        from repro_torch.models import xlstm
        self.xlstm, self.fn, self.ms = xlstm, xlstm.slstm_scan, []

    def __enter__(self):
        self.xlstm.slstm_scan = self
        return self

    def __exit__(self, *exc):
        self.xlstm.slstm_scan = self.fn

    def __call__(self, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def layer_walk(torch, cfg, params, batch, gate, tag, record=()):
    """G2: the plain prefill run layer by layer, and every layer also run
    through the kernels on the plain run's input.  Fails unless each
    layer's output and cache leaves lie within ``gate`` of the leaf's
    max |plain|.  Returns the mLSTM inputs (q, k, v, i, f) that the plain
    run fed the layers whose index is in ``record``."""
    from repro_torch.models import model as M
    from repro_torch.models.config import MLSTM
    params = M.cast_params(cfg, params)
    x = M._embed(cfg, params, batch["tokens"])
    recorded, worst, slstm = {}, (0.0, ""), []
    for i in range(cfg.n_scan):
        slot = M._tree_map(lambda t: t[i], params["scan"])
        for j, spec in enumerate(cfg.pattern):
            idx = i * cfg.period + j
            lp = slot[f"s{j}"]
            with MlstmRecorder() as rec:
                yp, cp, _ = M._apply_layer(cfg, spec, lp, x, None, True, None,
                                           False)
            if idx in record:
                recorded[idx] = rec.args
            yk, ck, _ = M._apply_layer(cfg, spec, lp, x, None, True, None, None)
            r = leaf_ratios(f"{tag} layer {idx}", {"out": yk, "cache": ck},
                            {"out": yp, "cache": cp})
            layer_worst = max((v, p) for p, v in r.items())
            if spec[0] == MLSTM:
                if layer_worst[0] > gate:
                    fail(f"{XLSTM} {tag}: layer {idx} (mLSTM) fed the plain "
                         f"run's input reads {layer_worst[0]} at "
                         f"{layer_worst[1]}, above {gate}")
                worst = max(worst, (layer_worst[0], f"layer {idx} "
                                    f"{layer_worst[1]}"))
            else:
                slstm.append(layer_worst[0])
            x = yp
            del yk, ck, cp
    return recorded, worst, slstm


def full_depth_pass(torch, out_k, step_p, params, batch, nudged):
    """``out_k``, a prefill through the kernels, against the plain prefill,
    and the plain version against itself on embeddings nudged by one ulp:
    (ratios, ratios)."""
    out_p = step_p(params, batch)
    kp = leaf_ratios(f"{XLSTM} kernels vs plain", out_k, out_p)
    tok = params["embed"]["tok"]
    params["embed"]["tok"] = nudged
    try:
        out_n = step_p(params, batch)
    finally:
        params["embed"]["tok"] = tok
    nn = leaf_ratios(f"{XLSTM} nudged vs plain", out_n, out_p)
    return kp, nn


def phase_xlstm(torch, dev, counters):
    """xlstm-1.3b at full width and XLSTM_LAYERS of its 48 layers (B 2,
    L 4096; 1 sLSTM and 7 mLSTM layers a period).  The counted bf16
    prefill (its ``mlstm_chunkwise`` launches must be LAUNCHES_PER_CALL
    per mLSTM layer); bf16 prefills timed through the kernels and through
    their plain versions; per leaf, kernels (the counted prefill in bf16)
    against plain beside the plain version against itself with the
    embeddings one ulp up, in bf16 and in float32 (gate: finite); G2 in bf16 (0.1) and float32 (1e-4); G1 at full width on
    the inputs the bf16 and the float32 plain runs feed their first and
    last mLSTM layer (bf16 q, k, v in the layout the model's einsum
    leaves them); G3 on the first period against float64.  Returns the
    launches, the worst G1 |diff| and the last mLSTM layer's inputs per
    input type (for phase 21)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm_chunk.kernel import LAUNCHES_PER_CALL
    from repro_torch.models.config import MLSTM, SLSTM
    from repro_torch.models.model import count_params, make_prefill_step
    t_phase = time.perf_counter()
    cfg = get_config(XLSTM)
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=XLSTM_LAYERS).validate()
    B = XLSTM_BATCH
    kinds = [m for m, _ in cfg.layer_specs]
    want = {"flash_attention_call": 0, "selective_scan_call": 0,
            "mlstm_chunkwise_call": LAUNCHES_PER_CALL * kinds.count(MLSTM)}
    t0 = time.perf_counter()
    params, batch = prefill_inputs(torch, dev, cfg, B, PREFILL_SEEDS[0])
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
    print(f"[xlstm] {XLSTM}: {cfg.n_layers} of the published {published} "
          f"layers ({kinds.count(SLSTM)} sLSTM, {kinds.count(MLSTM)} mLSTM), "
          f"full width; {count_params(cfg)} parameters ({n_bytes} bytes on the "
          f"card, {cfg.compute_dtype}) drawn in "
          f"{time.perf_counter() - t0:.2f} s; B={B}, L={PROMPT}", flush=True)
    step_k = make_prefill_step(cfg)
    step_p = make_prefill_step(cfg, use_kernel=False)

    for c in counters:
        c.launches = 0
    out = step_k(params, batch)                    # the main path's run
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{XLSTM}: {name} launched {launches[name]} times in one "
                 f"prefill, expected {n}")
    print(f"[xlstm] launches in the counted prefill "
          f"{ {k: launches[k] for k in want} } ({LAUNCHES_PER_CALL} CUDA "
          f"launches per mlstm_chunkwise call, one call per mLSTM layer)",
          flush=True)
    ratios = {}
    ratios["bf16"] = full_depth_pass(
        torch, out, step_p, params, batch,
        nudge_up(torch, params["embed"]["tok"]))
    del out
    ms = {}
    for tag, step in (("kernels", step_k), ("plain", step_p)):
        ms[tag], peak = timed_prefill(torch, step, params, batch, 1)
        print(f"[xlstm] {XLSTM} bf16 {tag}: {ms[tag]} ms per prefill (1, "
              f"after earlier runs of both), {B * PROMPT / ms[tag] * 1e3} "
              f"prompt tokens/s, max_memory_allocated {peak} bytes",
              flush=True)
    with ScanTimer() as scans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_k(params, batch)
        torch.cuda.synchronize()
        ms["with scan timer"] = (time.perf_counter() - t0) * 1e3
    ms["slstm scans"] = scans.ms
    print(f"[xlstm] {XLSTM} bf16 through the kernels, the sLSTM scans timed "
          f"(the card synchronised around each): {len(scans.ms)} scans "
          f"{scans.ms} ms, {sum(scans.ms)} ms of the prefill's "
          f"{ms['with scan timer']} ms; {len(kinds) - len(scans.ms)} "
          f"mLSTM layers' mlstm_chunkwise: see [timing]", flush=True)
    first, last = kinds.index(MLSTM), len(kinds) - 1 - kinds[::-1].index(MLSTM)
    recorded, worst, slstm = layer_walk(torch, cfg, params, batch, 0.1,
                                        "bf16", record=(first, last))
    print(f"[xlstm] G2 bf16: all {cfg.n_layers} layers fed the bf16 plain "
          f"run's input, kernels vs plain worst leaf {worst[0]} ({worst[1]}; "
          f"gate 0.1); sLSTM layers (no kernel) {slstm}", flush=True)
    errs = full_width_g1(torch, cfg, recorded, "bf16")
    timing_args = {"bf16": recorded[last][:5]}
    del recorded

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    for node_path, t in list(leaves(params)):      # upcast leaf by leaf
        node = params
        *keys, leaf = node_path.split("/")
        for k in keys:
            node = node[k]
        node[leaf] = t.float()
        del t
    torch.cuda.empty_cache()
    out = make_prefill_step(cfg32)(params, batch)
    ratios["f32"] = full_depth_pass(
        torch, out, make_prefill_step(cfg32, use_kernel=False), params,
        batch, nudge_up(torch, params["embed"]["tok"]))
    del out
    print(f"[xlstm] full depth ({cfg.n_layers} layers, L {PROMPT}), per leaf "
          "max |diff| / max |plain|: kernels vs plain, and the plain "
          "version vs itself with the token embeddings one ulp up (not "
          "gated but for finite values: see G2 and G3)", flush=True)
    for path in ratios["bf16"][0]:
        print(f"[xlstm]   {path}: bf16 kernels {ratios['bf16'][0][path]} "
              f"nudge {ratios['bf16'][1][path]}; f32 kernels "
              f"{ratios['f32'][0][path]} nudge {ratios['f32'][1][path]}",
              flush=True)
    for dt in ("bf16", "f32"):
        kp, nn = ratios[dt]
        print(f"[xlstm] full depth {dt}: worst leaf kernels vs plain "
              f"{max(kp.values())}, nudge {max(nn.values())}", flush=True)

    recorded, worst, slstm = layer_walk(torch, cfg32, params, batch, 1e-4,
                                        "f32", record=(first, last))
    print(f"[xlstm] G2 float32: all {cfg.n_layers} layers fed the float32 "
          f"plain run's input, kernels vs plain worst leaf {worst[0]} "
          f"({worst[1]}; gate 1e-4); sLSTM layers (no kernel) {slstm}",
          flush=True)
    errs += full_width_g1(torch, cfg, recorded, "float32")
    timing_args["float32"] = recorded[last][:5]
    del recorded
    phase_g3(torch, cfg32, params, batch)
    del params
    torch.cuda.empty_cache()
    print(f"[xlstm] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches["mlstm_chunkwise_call"], max(errs), ms, timing_args


def full_width_g1(torch, cfg, recorded, tag):
    """G1 (mlstm_check) on the mLSTM inputs a plain prefill fed the
    recorded layers, as it fed them; prints the layout of q, k, v (the
    kernel reads it in place where ``reads_in_place`` holds).  Returns
    the max |kernel - plain| per layer."""
    from repro_torch.kernels.mlstm_chunk.kernel import (input_layout,
                                                        reads_in_place)
    errs = []
    for idx, args in recorded.items():
        q, k, v, *_ = args
        B, H, L, Dh = q.shape
        err, k_or, p_or = mlstm_check(torch, f"{tag} layer {idx} (full "
                                      "width)", args[:5], cfg.mlstm_chunk)
        errs.append(err)
        print(f"[xlstm] G1 full width, {tag}, layer {idx}'s inputs (B {B}, "
              f"H {H}, L {L}, Dh {Dh}; q, k, v {q.dtype}, (row stride, "
              f"batch, head matrix strides) {input_layout(q)}, read in place "
              f"{all(reads_in_place(t) for t in (q, k, v))}): kernel vs "
              f"plain max |diff| {err}; max |diff| from the float64 oracle: "
              f"kernel {k_or}, plain {p_or} (gate {MLSTM_TOL} + {MLSTM_TOL} "
              f"|ref| on both)", flush=True)
    return errs


def phase_g3(torch, cfg32, params, batch):
    """G3: the first period (8 layers) in float64 through the plain
    versions is the truth; per leaf, the float32 prefill through the
    kernels (K) and through the plain versions (P), each as max |diff| /
    max |float64|.  Gate: K <= 10 P + 1e-6."""
    import dataclasses

    from repro_torch.models.model import _tree_map, make_prefill_step
    cfg1 = dataclasses.replace(cfg32, n_layers=cfg32.period).validate()
    p1 = dict(params, scan=_tree_map(lambda t: t[:1], params["scan"]))
    p64 = _tree_map(lambda t: t.double(), p1)
    t0 = time.perf_counter()
    truth = make_prefill_step(dataclasses.replace(
        cfg1, compute_dtype="float64"), use_kernel=False)(p64, batch)
    del p64
    torch.cuda.empty_cache()
    t64 = time.perf_counter() - t0
    K = leaf_ratios("G3 kernels", make_prefill_step(cfg1)(p1, batch), truth)
    P = leaf_ratios("G3 plain", make_prefill_step(cfg1, use_kernel=False)(
        p1, batch), truth)
    for path in K:
        print(f"[xlstm] G3 {path}: K {K[path]} P {P[path]} K/P "
              f"{K[path] / P[path] if P[path] else float('nan')}", flush=True)
        if not K[path] <= 10 * P[path] + 1e-6:
            fail(f"G3: {path} of the float32 kernel prefill strays {K[path]} "
                 f"from float64, more than 10 x the plain float32 "
                 f"prefill's {P[path]} + 1e-6")
    print(f"[xlstm] G3: the first period ({cfg1.n_layers} layers, B "
          f"{batch['tokens'].shape[0]}, L {PROMPT}) against float64 (its "
          f"plain run {t64:.1f} s): every leaf K <= 10 P + 1e-6; worst K "
          f"{max(K.values())}, worst P {max(P.values())}, max K/P "
          f"{max(K[p] / P[p] for p in K if P[p])}", flush=True)


def mlstm_ops(B, H, L, Dh, ck):
    """Operations the chunkwise mLSTM needs from the zero state: S and
    (S.D) v over the causal half of each chunk (2 Dh a product pair),
    q C0^T for every chunk after the first, the state update for all."""
    n_full, tail = divmod(L, ck)
    sizes = [ck] * n_full + ([tail] if tail else [])
    ops = 0
    for c, n in enumerate(sizes):
        ops += 2 * 2 * Dh * n * (n + 1) // 2 + 2 * n * Dh * Dh
        if c:
            ops += 2 * n * Dh * Dh
    return B * H * ops


def mlstm_piece_ops(B, H, L, Dh, ck, bf16):
    """The tensor work the kernel's piece products do: six products of
    each of the four for float32 inputs; for bf16 ones S = q k^T once and
    the other three three times."""
    n_full, tail = divmod(L, ck)
    sizes = [ck] * n_full + ([tail] if tail else [])
    s = sum(2 * Dh * n * (n + 1) // 2 for n in sizes)        # S, (S.D) v
    c = sum(2 * n * Dh * Dh for n in sizes)                 # state update
    qc = c - 2 * sizes[0] * Dh * Dh                          # q C0^T
    if bf16:
        return B * H * (s + 3 * (s + c + qc))
    return B * H * 6 * (2 * s + c + qc)


def start_fmad_build():
    """Start ``nvcc`` on ``mlstm_chunk.cu`` with the build's flags but
    ``-fmad=true`` (beside the kernels' build); returns (process, lib)."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.KERNELS_DIR / "mlstm_chunk" / "csrc" / "mlstm_chunk.cu"
    lib = _build.BUILD_DIR / "mlstm_chunk-fmad.so"
    flags = [f if f != "-fmad=false" else "-fmad=true" for f in _build.FLAGS]
    proc = subprocess.Popen([_build._nvcc(), *flags, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def plan_with_lib(lib, args, ck):
    """``plan_mlstm_chunkwise`` bound to another build of the library."""
    import ctypes

    from repro_torch.kernels.mlstm_chunk import kernel as MK
    own = MK._lib
    alt = ctypes.CDLL(str(lib))
    alt.mlstm_chunk_launch.argtypes = own().mlstm_chunk_launch.argtypes
    alt.mlstm_chunk_launch.restype = ctypes.c_int
    MK._lib = lambda: alt
    try:
        return MK.plan_mlstm_chunkwise(*args, chunk=ck)
    finally:
        MK._lib = own


def time_mlstm(torch, inputs, err, n_launches, build, fmad):
    """mlstm_chunkwise at the slice's shape (the inputs the float32 and
    the bf16 plain prefills fed their last mLSTM layer, bf16 q, k, v in
    the einsum's layout) beside its plain version and its bound: the
    larger of the bytes over the HBM rate and the operations at the bf16
    tensor-core peak (the piece products' tensor work printed beside
    it).  Also the copy that reading bf16 q, k, v in place saves, and the
    whole call built with ``-fmad=true`` (``fmad``: the build started in
    phase 1) in turns with the build's own.  The row carries phase 1's
    report (``build``)."""
    from repro_torch.kernels.mlstm_chunk.kernel import (KERNEL_NAMES,
                                                        input_layout,
                                                        plan_mlstm_chunkwise)
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
    log, _ = fmad[0].communicate()
    if fmad[0].returncode != 0:
        fail(f"nvcc failed on mlstm_chunk.cu with -fmad=true:\n{log}")
    ck = 256
    B, H, L, Dh = inputs["float32"][0].shape
    n_ops = mlstm_ops(B, H, L, Dh, ck)
    res = {}
    for tag, a in inputs.items():
        dtype = a[0].dtype
        launch, (h, _) = plan_mlstm_chunkwise(*a, chunk=ck)
        ms, host = time_launches([launch], 10, warmup=2)
        per = {name: time_launches([lambda i=i: launch(i)], 10, warmup=1)[0]
               for i, name in enumerate(KERNEL_NAMES)}
        plain = time_ms(lambda: mlstm_chunkwise(*a, chunk=ck,
                                                use_kernel=False), reps=3)
        fmad_launch, (fmad_h, _) = plan_with_lib(fmad[1], a, ck)
        fmad_launch()
        torch.cuda.synchronize()
        fmad_diff = (fmad_h - h).abs().max().item()
        turns = {"-fmad=false": [], "-fmad=true": []}
        for name in ("-fmad=false", "-fmad=true", "-fmad=true",
                     "-fmad=false"):
            f = launch if name == "-fmad=false" else fmad_launch
            turns[name].append(time_launches([f], 10, warmup=2)[0])
        del fmad_launch, fmad_h
        print(f"[timing] mlstm_chunkwise {tag}: the whole call built with "
              f"-fmad=false (the build's) {turns['-fmad=false']} ms, with "
              f"-fmad=true {turns['-fmad=true']} ms (in turns false, true, "
              f"true, false); max |h(-fmad=true) - h(-fmad=false)| "
              f"{fmad_diff}", flush=True)
        copy_ms = None
        if dtype == torch.bfloat16:
            copy_ms = time_launches([lambda: [t.contiguous() for t in a[:3]]],
                                    10, warmup=2)[0]
            print(f"[timing] mlstm_chunkwise bf16: q, k, v as the prefill "
                  f"passes them ((row stride, batch, head matrix strides) "
                  f"{input_layout(a[0])}, read in place); copying them to "
                  f"(B, H, L, Dh) order, as tma_operand would for a layout "
                  f"the kernel could not read, takes {copy_ms} ms a call",
                  flush=True)
        item = a[0].element_size()
        n_bytes = (3 * B * H * L * Dh * item + (2 * B * H * L + B * H * L * Dh
                   + B * H * Dh * Dh + B * H * Dh + B * H) * 4)
        t_ops = n_ops / BF16_OPS_PER_S * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        bound, by = (t_ops, "operations") if t_ops >= t_bytes else \
            (t_bytes, "bytes")
        pieces = mlstm_piece_ops(B, H, L, Dh, ck, tag == "bf16")
        print(f"[timing] mlstm_chunkwise at {XLSTM}'s mLSTM layer (B {B}, H "
              f"{H}, L {L}, Dh {Dh}, chunk {ck}, {tag} q, k, v): kernel {ms} "
              f"ms (CUDA events over 10 back-to-back calls of its "
              f"{len(KERNEL_NAMES)} launches; host enqueue {host} ms; each "
              f"kernel alone, the same way: {per} ms); plain {plain} ms; "
              f"bound {bound} ms ({by}; {n_ops} operations at the bf16 "
              f"tensor-core peak {t_ops} ms, {n_bytes} bytes {t_bytes} ms) = "
              f"{bound / ms} of the bound; {n_ops / (ms * 1e-3) / 1e12} "
              f"TFLOP/s achieved on the operations needed; the piece "
              f"products' tensor work {pieces} operations, "
              f"{pieces / BF16_OPS_PER_S * 1e3} ms at the peak, "
              f"{pieces / (ms * 1e-3) / 1e12} TFLOP/s of it; no single "
              f"PyTorch call computes the chunkwise mLSTM, so no library "
              f"time", flush=True)
        res[tag] = dict(ms=ms, stages_ms=per, plain_ms=plain, bound_ms=bound,
                        bound_by=by, piece_ops=pieces, fmad_ms=turns,
                        layout_copy_ms=copy_ms)
        del a, launch, h
    return dict(
        name="mlstm_chunkwise", route="cuda",
        source="src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        replaces="src/repro/kernels/mlstm_chunk/kernel.py:80",
        launches=n_launches, max_abs_err=err, ms=res["float32"]["ms"],
        plain_ms=res["float32"]["plain_ms"],
        bound_ms=res["float32"]["bound_ms"],
        bound_by=res["float32"]["bound_by"], library_ms=None, inputs=res,
        build=build)


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phases 22-24: the durability and elastic planes at the smoke cell's width
# --------------------------------------------------------------------------

# retention rings and a dead-letter spool that hold real data
DURABLE = dict(retention_slots=16, dlq_slots=512)
SCRATCH = ROOT / "build"


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def compare_snapshots(tag, a, b) -> None:
    """Fail unless two engines' snapshots agree: every table, state leaf,
    stat, retention ring, dead letter, lookup map, plan array and backlog
    entry bitwise, and the registry mirror and host counters equal."""
    import torch
    (xa, ma), (xb, mb) = a.snapshot(), b.snapshot()
    if sorted(xa) != sorted(xb):
        fail(f"{tag}: snapshot keys differ: {sorted(set(xa) ^ set(xb))}")
    for k in xa:
        compare(f"{tag} {k}", torch.from_numpy(xa[k]),
                torch.from_numpy(xb[k]))
    if ma != mb:
        fail(f"{tag}: snapshot meta differs")


def post_random(engines, sources, rng, n, base_ts) -> None:
    """Post ``n`` SUs to random sources (repeats included, so bursts carry
    over) to every engine alike."""
    import numpy as np
    picks = rng.integers(0, len(sources), n)
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    ts = base_ts + rng.integers(0, 90, n)
    for e in engines:
        for j, v, t in zip(picks, vals, ts):
            e.post(sources[j].sid, v.tolist(), int(t))


def step_all(engines, K):
    """One superstep of K rounds (one round for K = 1) on each engine;
    returns each engine's per-round sinks."""
    if K == 1:
        return [[e.round()] for e in engines]
    return [e.spool_sinks(e.superstep(K)) for e in engines]


def compare_sinks(tag, runs) -> None:
    """Every engine's per-round sinks against the first engine's."""
    import torch
    for i, run in enumerate(runs[1:], 1):
        if len(run) != len(runs[0]):
            fail(f"{tag}: engine {i} ran {len(run)} rounds")
        for k, (a, b) in enumerate(zip(runs[0], run)):
            compare(f"{tag} engine {i} round {k}",
                    tuple(torch.as_tensor(x) for x in a),
                    tuple(torch.as_tensor(x) for x in b))


def want_launches(rounds, shards, path) -> dict:
    """Kernel launches of ``rounds`` rounds at ``shards`` shards."""
    if shards == 1:
        return {("fused_round_call" if path == "fused"
                 else "sched_pop_call"): rounds}
    return {"sched_pop_call": shards * rounds,
            "exchange_compact_call": rounds, "by_sid_snapshot_call": rounds,
            "apply_programs_call": rounds if path == "fused" else 0}


def check_launches(tag, counters, want) -> dict:
    got = {c.__name__: c.launches for c in counters}
    for k, n in want.items():
        if got[k] != n:
            fail(f"{tag}: {k} launched {got[k]} times (want {n}); {got}")
    return got


def timed(torch, dev, fn):
    """``(fn(), ms)`` on the host clock, the card synchronised on both
    sides."""
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, (time.perf_counter() - t0) * 1e3


def phase_kill_resume(torch, dev, reg, sources, shards, counters, smi):
    """Phase 22 on one configuration of the smoke cell (``reg``'s path, at
    ``shards`` shards): engine A checkpoints to a directory every second
    superstep of K = 4 (asynchronous saves), engine B and a plain-version
    engine take the same input without interruption.  After four
    supersteps A is deleted and ``restore_engine`` rebuilds it from the
    newest checkpoint; the restored engine, B and the plain engine take one
    eager round and one superstep more.  Gates: the restored engine
    equals B at the resume point and at the end (every snapshot array and
    every sink bitwise) and equals the plain engine; the kernels launched
    once per round of the three kernel engines.  Then one leaf of the
    newest checkpoint is truncated: ``load`` of it must raise
    ``CheckpointCorrupt`` and ``restore_engine`` must fall back to the one
    before, equal to B's snapshot there.  Times (host clock, card
    synchronised): ``snapshot()`` and its bytes (and the registry
    mirror's share of it, ``Registry.to_snapshot``), ``save_sync``, the
    blocking part of ``save_async`` (the snapshot and the call),
    ``restore_engine`` from disk, and the first round after the restore
    beside the same round of B."""
    import shutil
    import statistics
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import create_engine, restore_engine
    K, before, after = 4, 4, 1
    B = reg.cfg.batch
    kw = dict(DURABLE, superstep=K, checkpoint_every=2)
    if shards > 1:
        kw.update(n_shards=shards, exchange_slots=0)
    e_a = create_engine(copy_registry(reg, **kw), device=dev)
    e_b = create_engine(copy_registry(reg, **kw), device=dev)
    e_p = plain_engine(copy_registry(reg, **kw), dev)
    path = e_b._path
    tag = f"kill-resume {path} D={shards}"
    SCRATCH.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=SCRATCH))
    try:
        mgr = e_a.checkpoint_to(str(root), keep=3)
        rng = np.random.default_rng(SEED + 22)
        for c in counters:
            c.launches = 0
        at = {}
        for s in range(before):
            post_random([e_a, e_b, e_p], sources, rng, K * B, 100 * s)
            compare_sinks(f"{tag} superstep {s}",
                          step_all([e_a, e_b, e_p], K))
            at[e_b._steps_done] = e_b.snapshot()
        mgr.wait()
        steps = ckpt.all_steps(str(root))
        if steps != [2, 4]:
            fail(f"{tag}: checkpoints at steps {steps}, want [2, 4]")
        del e_a, mgr                        # the crash
        e_r, ms_restore = timed(torch, dev, lambda: restore_engine(
            str(root), device=dev))
        if e_r._steps_done != before or e_r._path != path:
            fail(f"{tag}: restored step {e_r._steps_done}, path {e_r._path}")
        compare_snapshots(f"{tag} restored vs survivor", e_r, e_b)
        post_random([e_r, e_b, e_p], sources, rng, B, 100 * before)
        firsts = [timed(torch, dev, e.round) for e in (e_r, e_b, e_p)]
        compare_sinks(f"{tag} first round", [[x] for x, _ in firsts])
        for s in range(before, before + after):
            post_random([e_r, e_b, e_p], sources, rng, K * B, 100 * s + 50)
            compare_sinks(f"{tag} superstep {s}",
                          step_all([e_r, e_b, e_p], K))
        compare_snapshots(f"{tag} restored vs survivor", e_r, e_b)
        compare_snapshots(f"{tag} restored vs plain", e_r, e_p)
        rounds = before * K + 2 * (1 + after * K) + before * K
        launches = check_launches(tag, counters,
                                  want_launches(rounds, shards, path))
        # a torn newest checkpoint: the one before it is restored
        leaf = root / f"step_{steps[-1]:08d}" / "state_values.npy"
        leaf.write_bytes(leaf.read_bytes()[:-16])
        try:
            ckpt.load(str(root), steps[-1])
            fail(f"{tag}: a truncated leaf loaded without CheckpointCorrupt")
        except ckpt.CheckpointCorrupt:
            pass
        e_f = restore_engine(str(root), device=dev)
        if e_f._steps_done != steps[-2]:
            fail(f"{tag}: the fallback restored step {e_f._steps_done}")
        (xf, mf), (xb, mb) = e_f.snapshot(), at[steps[-2]]
        for k in xb:
            compare(f"{tag} fallback {k}", torch.from_numpy(xf[k]),
                    torch.from_numpy(xb[k]))
        if mf != mb or sorted(xf) != sorted(xb):
            fail(f"{tag}: the fallback's meta or keys differ")
        del e_f
        # times on the survivor
        snaps = [timed(torch, dev, e_b.snapshot) for _ in range(5)]
        mirror = [timed(torch, dev, e_b.registry.to_snapshot)[1]
                  for _ in range(5)]
        arrays, meta = snaps[-1][0]
        n_bytes = sum(a.nbytes for a in arrays.values())
        times = ckpt.CheckpointManager(str(root / "times"), keep=1)
        ms_sync = [timed(torch, dev, lambda: times.save_sync(
            10 + i, arrays, extra=meta))[1] for i in range(3)]
        ms_async = []
        for i in range(3):
            ms_async.append(timed(torch, dev, lambda: times.save_async(
                20 + i, *e_b.snapshot()))[1])
            times.wait()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = statistics.median
    c = e_r.counters()
    print(f"[{tag}] {reg.n_active} streams, retention 16, DLQ 512: "
          f"checkpoints at supersteps {steps} of K={K} (asynchronous), "
          f"engine deleted after {before}; restore_engine == survivor "
          f"(every snapshot array) at the resume point and after 1 round "
          f"and {after} supersteps more, == the plain engine, every sink "
          f"bitwise; truncated newest leaf: CheckpointCorrupt, fallback to "
          f"step {steps[-2]} == the survivor's snapshot there; launches "
          f"{launches}; processed={c['processed']} emitted={c['emitted']} "
          f"dropped_overflow={c['dropped_overflow']} "
          f"DLQ fill {e_r.state.dlq_fill.sum().item()}", flush=True)
    print(f"[durability times {path} D={shards}] {smi}: snapshot() "
          f"{med(ms for _, ms in snaps)} ms for {n_bytes} bytes (the "
          f"registry mirror alone {med(mirror)} ms); "
          f"save_sync {med(ms_sync)} ms; save_async blocking (snapshot and "
          f"call) {med(ms_async)} ms; restore_engine from disk {ms_restore} "
          f"ms; first round after the restore {firsts[0][1]} ms (the "
          f"survivor's same round {firsts[1][1]} ms, plain {firsts[2][1]} "
          f"ms)", flush=True)
    return ms_restore


def phase_redelivery(torch, dev, reg, sources, shards, counters):
    """Phase 23 at ``shards`` shards: one script on a kernel engine and a
    plain-version engine (``reg``'s fused path, retention 16, DLQ 512),
    every snapshot array and sink bitwise after each step: six rounds of
    history; a late joiner admitted with ``replay=True`` on the source
    with the most retained history (its program swapped to read both
    inputs); SUs shed by a quota of 1 on one tenant, drained and
    redelivered with the quota lifted; a queued composite revoked and its
    purged SUs redelivered, which must be refused, spooled again with
    their reason and counted in ``redeliver_rejected``; eight rounds after
    each step.  The kernels must have launched once per round."""
    import numpy as np
    from repro_torch.core import create_engine
    kw = dict(DURABLE)
    if shards > 1:
        kw.update(n_shards=shards, exchange_slots=0)
    tag = f"redeliver D={shards}"
    e_k = create_engine(copy_registry(reg, **kw), device=dev)
    e_p = plain_engine(copy_registry(reg, **kw), dev)
    engines = (e_k, e_p)
    if e_k._path != "fused":
        fail(f"{tag}: the engine took the {e_k._path} path")
    rng = np.random.default_rng(SEED + 23)
    B = reg.cfg.batch
    n_rounds, log = 0, []
    for c in counters:
        c.launches = 0

    def rounds(n, what):
        nonlocal n_rounds
        compare_sinks(f"{tag} {what}",
                      [[e.round() for _ in range(n)] for e in engines])
        n_rounds += n

    def both(name, fn, n_inner=0):
        nonlocal n_rounds
        out = [fn(e) for e in engines]
        n_rounds += n_inner
        if out[0] != out[1]:
            fail(f"{tag} {name}: kernels {out[0]}, plain {out[1]}")
        compare_snapshots(f"{tag} {name}", e_k, e_p)
        log.append(f"{name} {out[0]}")
        return out[0]

    for r in range(6):                      # history in the retention rings
        post_random(engines, sources, rng, B, 10 * r)
        rounds(1, f"history {r}")
    count = e_k._by_sid(e_k.state.ret_count)
    h = max(sources, key=lambda s: (int(count[s.sid]), -s.sid))
    other = next(s for s in sources if s.sid != h.sid)

    def replay(e):
        r = e.registry
        late = e.admit_composite(r.tenants[0], "late", CHANNELS,
                                 [r.streams[other.sid]],
                                 {ch: f"in0.{ch}" for ch in CHANNELS})
        n0 = e.counters()["replayed"]
        ok = e.admit_subscription(late, r.streams[h.sid], replay=True)
        e.swap_program(late, {ch: f"in0.{ch} + in1.{ch} * 2.0"
                              for ch in CHANNELS})
        return ok, e.counters()["replayed"] - n0

    ok, replayed = both("replay", replay)
    if not ok or replayed != min(int(count[h.sid]), DURABLE["retention_slots"]):
        fail(f"{tag}: replayed {replayed} of {int(count[h.sid])} retained")
    rounds(8, "after the replay")
    tid = sources[0].tenant
    mine = [s for s in sources if s.tenant == tid][:B]

    def quota(e):
        e.dead_letters()                    # an empty spool to start from
        e.set_quota(tid, 1)
        for i, s in enumerate(mine):
            e.post(s.sid, [float(i), 1.0, 2.0, 3.0], 5000 + i)
        e.round()
        letters = e.dead_letters(clear=False)
        shed = sum(lt.reason == "quota" for lt in letters)
        e.set_quota(tid, 0)
        return shed, len(letters), e.redeliver()

    shed, n_letters, n = both("quota", quota, 1)
    if not (shed > 0 and n == n_letters):
        fail(f"{tag}: {shed} shed, {n} of {n_letters} letters redelivered")
    rounds(8, "after the quota redelivery")
    post_random(engines, sources, rng, B, 6000)
    rounds(1, "before the revoke")
    queued = set(e_k.state.q_sid[e_k.state.q_valid].tolist())
    comps = sorted(s.sid for s in e_k.registry.streams
                   if s is not None and s.composite and s.sid in queued)
    if not comps:
        fail(f"{tag}: no composite queued to revoke")
    x = comps[0]

    def revoke(e):
        e.dead_letters()
        n0 = e.counters()["redeliver_rejected"]
        e.revoke_stream(e.registry.streams[x])
        purged = sum(lt.sid == x for lt in e.dead_letters(clear=False))
        n = e.redeliver()
        kept = [lt.reason for lt in e.dead_letters(clear=False)
                if lt.sid == x]
        return purged, n, e.counters()["redeliver_rejected"] - n0, kept

    purged, n, rejected, kept = both("revoke", revoke)
    if not (purged > 0 and rejected == purged == len(kept)
            and set(kept) == {"revoked"} and n == 0):
        fail(f"{tag}: revoked sid {x}: {purged} purged, {n} redelivered, "
             f"{rejected} rejected, kept {kept}")
    rounds(8, "after the refused redelivery")
    launches = check_launches(tag, counters,
                              want_launches(n_rounds, shards, "fused"))
    c = e_k.counters()
    print(f"[{tag}] kernels bitwise equal to the plain versions after each "
          f"step (every snapshot array and sink): {'; '.join(log)}; "
          f"{n_rounds} rounds, launches {launches}; replayed={c['replayed']} "
          f"redeliver_rejected={c['redeliver_rejected']} "
          f"dropped_quota={c['dropped_quota']} "
          f"dropped_overflow={c['dropped_overflow']}", flush=True)


def autoscale_run(dev, reg, sources, use_kernel):
    """``tests/test_elastic.py``'s autoscaler feed at the smoke width: an
    ``Autoscaler(min_shards=1, max_shards=4, up=0.25, down=0.05,
    patience=1, cooldown=0)`` observing every superstep of K = 2; a burst
    of 2 x batch posts a superstep for up to 12 supersteps (until 4
    shards), then supersteps with no posts until the engine is back at 1
    shard with an empty queue (at most 96)."""
    import numpy as np
    from repro_torch.core import create_engine
    from repro_torch.launch import Autoscaler
    eng = create_engine(copy_registry(reg, **DURABLE, exchange_slots=0,
                                      superstep=2),
                        device=dev, use_kernel=use_kernel)
    sc = Autoscaler(eng, min_shards=1, max_shards=4, up=0.25, down=0.05,
                    patience=1, cooldown=0)
    rng = np.random.default_rng(SEED + 24)
    B = eng.cfg.batch
    for w in range(12):
        post_random([eng], sources, rng, 2 * B, 100 * w)
        eng.superstep(2)
        sc.observe()
        if eng.cfg.n_shards == 4:
            break
    for _ in range(96):
        eng.superstep(2)
        sc.observe()
        if eng.cfg.n_shards == 1 and sc.occupancy() == 0.0:
            break
    return eng, sc


def phase_elastic(torch, dev, reg, sources, counters, smi):
    """Phase 24: the resize chain 1 -> 2 -> 4 -> 2 -> 1 on a kernel engine
    and a plain-version engine (``reg``'s fused path, retention 16, DLQ
    512, K = 4), a superstep of 4 x batch posts before each hop so that
    the queue is loaded when it moves.  Gates at every hop: the resized
    engine equals ``restore_engine(snapshot, n_shards=M)`` taken just
    before (every snapshot array), and the plain engine resized alike;
    after one more superstep on the same input all three still agree
    (every sink); the kernels launched once per round of the two kernel
    engines at the new shard count (so ``exchange_compact`` and
    ``apply_programs`` at D = 2).  Then :func:`autoscale_run` through the
    kernels and through the plain versions: at least one scale-up and one
    scale-down, the same scale events and the same final engine."""
    import dataclasses
    import numpy as np
    from repro_torch.core import create_engine, restore_engine
    K = 4
    kw = dict(DURABLE, exchange_slots=0, superstep=K)
    e = create_engine(copy_registry(reg, **kw), device=dev)
    e_p = plain_engine(copy_registry(reg, **kw), dev)
    rng = np.random.default_rng(SEED + 24)
    B = reg.cfg.batch
    hops, ms_hops, seen = [], [], {1: e._fns}
    for i, n_to in enumerate((2, 4, 2, 1)):
        n_from = e.cfg.n_shards
        post_random([e, e_p], sources, rng, K * B, 1000 * i)
        compare_sinks(f"elastic before ->{n_to}", step_all([e, e_p], K))
        occ = int(e.state.q_valid.sum())
        if occ == 0:
            fail(f"elastic: the queue is empty before the resize to {n_to}")
        snap = e.snapshot()
        _, ms = timed(torch, dev, lambda: e.resize(n_to))
        e_p.resize(n_to)
        if n_to in seen and e._fns is not seen[n_to]:
            fail(f"elastic: the return to {n_to} shards rebuilt its closures")
        seen[n_to] = e._fns
        oracle = restore_engine(snap, n_shards=n_to, device=dev)
        compare_snapshots(f"elastic resize ->{n_to} vs restore", e, oracle)
        compare_snapshots(f"elastic resize ->{n_to} kernels vs plain", e, e_p)
        for c in counters:
            c.launches = 0
        post_random([e, oracle, e_p], sources, rng, K * B, 1000 * i + 500)
        compare_sinks(f"elastic at {n_to}", step_all([e, oracle, e_p], K))
        launches = check_launches(f"elastic at {n_to} shards", counters,
                                  want_launches(2 * K, n_to, "fused"))
        compare_snapshots(f"elastic at {n_to} vs restore", e, oracle)
        compare_snapshots(f"elastic at {n_to} kernels vs plain", e, e_p)
        hops.append(f"{n_from}->{n_to} {ms} ms (queue {occ}; launches "
                    f"{ {k: n for k, n in launches.items() if n} })")
        ms_hops.append(f"{n_from}->{n_to} {ms}")
        del oracle
    runs = [autoscale_run(dev, reg, sources, u) for u in (None, False)]
    (e_k, s_k), (e_pl, s_pl) = runs
    ev = [dataclasses.asdict(x) for x in s_k.events]
    if ev != [dataclasses.asdict(x) for x in s_pl.events]:
        fail(f"autoscaler: kernel events {ev}, plain "
             f"{[dataclasses.asdict(x) for x in s_pl.events]}")
    if not (any(x.to_shards > x.from_shards for x in s_k.events)
            and any(x.to_shards < x.from_shards for x in s_k.events)
            and e_k.cfg.n_shards == 1):
        fail(f"autoscaler: events {ev}, ending at {e_k.cfg.n_shards} shards")
    compare_snapshots("autoscaler kernels vs plain", e_k, e_pl)
    print(f"[elastic] resize chain 1->2->4->2->1 with a loaded queue at "
          f"each hop: each resize == restore_engine(snapshot, n_shards=M), "
          f"kernels == plain (every snapshot array and sink), the return to "
          f"a layout reuses its closures; {'; '.join(hops)}", flush=True)
    print(f"[elastic times] {smi}: resize ms per hop "
          f"{'; '.join(ms_hops)}", flush=True)
    print(f"[autoscale] {s_k._steps} observations, events "
          f"{[(x.step, x.from_shards, x.to_shards, x.reason) for x in s_k.events]}"
          f" equal through the kernels and the plain versions, final engine "
          f"equal (every snapshot array); processed="
          f"{e_k.counters()['processed']} "
          f"dropped_overflow={e_k.counters()['dropped_overflow']}",
          flush=True)


# --------------------------------------------------------------------------
# phase 25: the chaos drill under the self-healing supervisor
# --------------------------------------------------------------------------

# the drill's schedule (checkpoints after supersteps 2, 4, ...): the
# hostile swap at superstep 2, then the newest checkpoint (4) torn and a
# kill at 4, which restores 2 and replays 2-4 (the swap included); a
# second kill at 5 restores the 4 rewritten by that replay.  Short, and
# supersteps of CHAOS_K rounds, because the plain 4-shard engine takes
# ~0.7-1.1 s a round.  SUs posted to the cell's sources each superstep:
CHAOS_STEPS, CHAOS_TEAR, CHAOS_HOSTILE, CHAOS_KILLS = 6, 4, 2, (4, 5)
CHAOS_RESTORED = [2, 4]
CHAOS_POSTS = 16
CHAOS_K = 4


def chaos_registry(reg, shards):
    """The drill's registry: ``reg`` with retention 16, a spool of 512,
    K = CHAOS_K, a checkpoint every second superstep and the breaker
    armed (2 faults in 8 rounds trip), plus an island of tenant 0 that no
    other stream reads: sources x0 and x1, and composites xc (``in0 * 2
    + in1``) and xh (``in0 - in1``, the hostile swap's target).  Returns
    the registry, the island's sids and the per-sid pop priority: the
    island is served after every other stream (priority 1), so that its
    extra SUs (the doubled poison posts, the storm) take no pop slot from
    a co-tenant and the deficit gate reads fault isolation alone, not the
    QoS plane's sharing of a loaded queue."""
    import numpy as np
    kw = dict(DURABLE, superstep=CHAOS_K, checkpoint_every=2, fault_window=8,
              fault_threshold=2)
    if shards > 1:
        kw.update(n_shards=shards, exchange_slots=0)
    r = copy_registry(reg, **kw)
    t = r.tenants[0]
    x0 = r.create_stream(t, "chaos_x0", CHANNELS)
    x1 = r.create_stream(t, "chaos_x1", CHANNELS)
    xc = r.create_composite(t, "chaos_xc", CHANNELS, [x0, x1],
                            {ch: f"in0.{ch} * 2.0 + in1.{ch}"
                             for ch in CHANNELS})
    xh = r.create_composite(t, "chaos_xh", CHANNELS, [x0, x1],
                            {ch: f"in0.{ch} - in1.{ch}" for ch in CHANNELS})
    island = (x0.sid, x1.sid, xc.sid, xh.sid)
    priority = np.zeros((r.cfg.n_streams,), np.int32)
    priority[list(island)] = 1
    return r, island, priority


def chaos_feed(sources, island, monkey, poison=True):
    """The drill's feed, a pure function of the step (the supervisor's
    replay calls it again): ``CHAOS_POSTS`` SUs to random sources of the
    cell, then one SU on each island source.  With ``poison``, the
    monkey's poison steps post two poisoned payloads of the scheduled kind
    to each island source instead (two rounds running, so that the
    breaker's 2 faults in 8 rounds trip), its storm steps add a storm of 16 SUs
    over them, and its hostile step swaps xh's program for the overflow
    one; without, the island takes plain SUs only (the clean engine).  The
    draws come from a generator seeded by the step."""
    import numpy as np
    from repro_torch.launch import (inject_hostile_program,
                                    inject_ingest_storm,
                                    inject_payload_corruption)
    x0, x1, _, xh = island

    def feed(e, step):
        rng = np.random.default_rng([SEED, 25, step])
        ts = 1000 * step
        post_random([e], sources, rng, CHAOS_POSTS, ts)
        kinds = {ev.kind: ev.detail for ev in monkey.events_at(step)}
        vals = rng.standard_normal((2, len(CHANNELS))).astype(np.float32)
        if poison and "poison" in kinds:
            for dt in (100, 101):           # two rounds: the breaker trips
                for sid in (x0, x1):
                    inject_payload_corruption(e, sid, ts + dt, rng,
                                              kinds["poison"])
        else:
            for sid, v in zip((x0, x1), vals):
                e.post(sid, v.tolist(), ts + 100)
        if poison and "storm" in kinds:
            inject_ingest_storm(e, [x0, x1], ts + 102, rng, n=16)
        if poison and "hostile" in kinds:
            s = e.registry.streams
            inject_hostile_program(e, s[xh], [s[x0], s[x1]], rng)
    return feed


def phase_chaos(torch, dev, reg, sources, shards, counters, smi,
                ms_restores):
    """Phase 25 at ``shards`` shards (``reg``'s fused path; at 4 shards
    every engine fans out through ``make_fanout()``): a ``Supervisor``
    drives a kernel engine through ``CHAOS_STEPS`` supersteps of CHAOS_K
    under a seeded ``ChaosMonkey``: poisoned payloads on the island's
    sources, a storm, the hostile overflow swap, a torn newest checkpoint
    with a ``ShardKill``, and a second kill.  Beside it an undisturbed
    twin and its plain-version engine take the same feed (sinks compared
    every superstep), and a clean engine the feed without the island's
    injections.  Gates: both incidents recovered (the first past the torn
    checkpoint); the restored engine on the card with the fan-out and
    kernel choice it had; the kernels launched once per round of every
    superstep the supervised engines ran, restore and replay included (at
    4 shards ``stream_dispatch`` once per shard and round); recovered ==
    twin == plain (every snapshot array), and the recovered engine's
    sinks == the twin's over one superstep more; the island's composites, and only they, quarantined by the
    breaker, not by escalation; after a drain, the co-tenants' emissions
    in the twin equal the clean engine's (deficit 0).  Prints each
    incident's ``downtime_s`` (MTTR, host clock) and the synchronised
    host time of the step that recovered, beside phase 22's
    ``restore_engine`` times of this run."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import create_engine
    from repro_torch.kernels.stream_dispatch.ops import make_fanout
    from repro_torch.launch import (ChaosMonkey, ShardKill, Supervisor,
                                    corrupt_checkpoint)
    K = CHAOS_K
    tag = f"chaos D={shards}"
    base, island, priority = chaos_registry(reg, shards)
    x0, x1, xc, xh = island

    def engine(use_kernel=None):
        fan = ({} if shards == 1
               else {"fanout_fn": make_fanout(use_kernel=use_kernel)})
        return create_engine(copy_registry(base), device=dev,
                             priority=priority, use_kernel=use_kernel, **fan)

    t0 = time.perf_counter()
    e_s, e_t, e_p, e_c = engine(), engine(), engine(False), engine()
    parts = {"engines": time.perf_counter() - t0}
    monkey = ChaosMonkey(SEED + 25, CHAOS_STEPS, p_poison=0.5, p_storm=0.25,
                         kill_steps=CHAOS_KILLS, tear_steps=(CHAOS_TEAR,),
                         hostile_steps=(CHAOS_HOSTILE,))
    kinds = [(ev.step, ev.kind, ev.detail) for ev in monkey.events]
    if not {"poison", "storm"} <= {k for _, k, _ in kinds}:
        fail(f"{tag}: the schedule {kinds} has no poison or no storm")
    feed = chaos_feed(sources, island, monkey)
    SCRATCH.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_", dir=SCRATCH))

    def chaos(e, step):
        evs = {ev.kind for ev in monkey.events_at(step)}
        if "tear" in evs:
            e._ckpt.wait()
            if corrupt_checkpoint(str(root), monkey.rng,
                                  mode="truncate") is None:
                fail(f"{tag}: no checkpoint to tear at step {step}")
        if "kill" in evs:
            e._ckpt.wait()
            raise ShardKill(f"chaos drill kill @{step}")

    try:
        t0 = time.perf_counter()
        sup = Supervisor(e_s, str(root), feed=feed, chaos=chaos, K=K)
        for c in counters:
            c.launches = 0
        ms_steps, ms_recover = [], {}
        for step in range(CHAOS_STEPS):
            inc, ms = timed(torch, dev, lambda: sup.step(step))
            if inc is None:
                ms_steps.append(ms)
            else:
                ms_recover[step] = ms
        e_r = sup.engine
        e_r.checkpoint_to(None)             # awaits the last save
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parts["supervised"] = time.perf_counter() - t0
    incs = sup.incidents
    n_super = CHAOS_STEPS - len(incs) + sum(i.replayed_steps for i in incs)
    want = want_launches(n_super * K, shards, "fused")
    if shards > 1:
        want["stream_dispatch_call"] = shards * n_super * K
    launches = check_launches(f"{tag} supervised", counters, want)
    if [(i.kind, i.step) for i in incs] != [("crash", s) for s in CHAOS_KILLS]:
        fail(f"{tag}: incidents {incs}")
    if [i.restored_step for i in incs] != CHAOS_RESTORED:
        fail(f"{tag}: restored steps {[i.restored_step for i in incs]}")
    if e_r is e_s or e_r.device != e_s.device or \
            e_r._fanout_fn is not e_s._fanout_fn or \
            e_r.use_kernel is not None or e_r._path != "fused":
        fail(f"{tag}: the restored engine runs on {e_r.device} with "
             f"use_kernel={e_r.use_kernel}, path {e_r._path}")
    del e_s
    # the undisturbed twin and its plain engine, and the clean engine
    t0 = time.perf_counter()
    clean = chaos_feed(sources, island, monkey, poison=False)
    escalated = {i.step: i.escalated for i in incs}
    for step in range(CHAOS_STEPS):
        feed(e_t, step)
        feed(e_p, step)
        clean(e_c, step)
        compare_sinks(f"{tag} twin vs plain, superstep {step}",
                      step_all([e_t, e_p], K))
        e_c.superstep(K)
        for sid in escalated.get(step, ()):
            e_t.quarantine(sid)
            e_p.quarantine(sid)
    compare_snapshots(f"{tag} recovered vs twin", e_r, e_t)
    compare_snapshots(f"{tag} twin vs plain", e_t, e_p)
    del e_p
    step = CHAOS_STEPS                      # one superstep more: the sinks
    for e in (e_r, e_t):
        feed(e, step)
    compare_sinks(f"{tag} after the drill", step_all([e_r, e_t], K))
    compare_snapshots(f"{tag} recovered vs twin, after", e_r, e_t)
    clean(e_c, step)
    e_c.superstep(K)
    fc = e_r.fault_counters()
    quarantined = sorted(int(s) for s in np.nonzero(fc["quarantined"])[0])
    if quarantined != sorted((xc, xh)) or any(i.escalated for i in incs):
        fail(f"{tag}: quarantined {quarantined}, escalated "
             f"{[i.escalated for i in incs]}; the island is {island}")
    parts["twin, plain, clean"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # drain the twin and the clean engine, then count co-tenant emissions
    for n_drain in range(1, 17):
        for e in (e_t, e_c):
            e.superstep(K)
        if all(not e._pending and int(e.state.q_valid.sum()) == 0
               for e in (e_t, e_c)):
            break
    else:
        fail(f"{tag}: the twin and the clean engine did not drain")
    tid = base.tenants[0].tid
    co = np.arange(base.cfg.n_tenants) != tid
    em_t = e_t.tenant_counters()["emitted"][co]
    em_c = e_c.tenant_counters()["emitted"][co]
    deficit = int(np.maximum(em_c - em_t, 0).sum())
    if deficit or not np.array_equal(em_t, em_c):
        fail(f"{tag}: co-tenant emissions {em_t.tolist()} in the twin, "
             f"{em_c.tolist()} clean (deficit {deficit})")
    parts["drain"] = time.perf_counter() - t0
    c = e_r.counters()
    print(f"[{tag}] schedule {kinds}; incidents "
          f"{[(i.step, i.restored_step, i.replayed_steps, i.blamed) for i in incs]}"
          f" (step, restored step, replayed, blamed); recovered == twin == "
          f"plain (every snapshot array; the twin's sinks == plain's every "
          f"superstep, the recovered engine's == the twin's one more); "
          f"launches across the restores {launches} for {n_super} "
          f"supersteps; quarantined by the breaker {quarantined} (island "
          f"{island}); co-tenant emissions {int(em_t.sum())} == clean, "
          f"deficit 0 after {n_drain} drain supersteps; "
          f"dropped_poisoned={c['dropped_poisoned']} "
          f"dropped_overflow={c['dropped_overflow']}", flush=True)
    print(f"[chaos times D={shards}] {smi}: MTTR (downtime_s, host clock) "
          f"{[i.downtime_s * 1e3 for i in incs]} ms; the recovering step "
          f"synchronised {ms_recover} ms; a step without incident "
          f"{sorted(ms_steps)[len(ms_steps) // 2]} ms (median); phase 22's "
          f"restore_engine from disk {ms_restores} ms; the phase's parts "
          f"(s): {parts}", flush=True)


# --------------------------------------------------------------------------
# phases 26-28: the serving path (decode step, batcher, PRED flows)
# --------------------------------------------------------------------------

# jamba's Mamba layer at one decode token per slot: (B, L, Di, S)
DECODE_SCAN = (4, 1, 8192, 16)
# (arch, one period only, B, L): gemma3-1b at its published depth, L 1,536
# so that its local layers' 512-slot rings wrap; jamba's and xlstm-1.3b's
# first period (8 layers each).  jamba's L is 512 because its MoE groups
# min(512, L) tokens and must divide both L and L - 1.
DECODE_MODELS = (("gemma3-1b", False, 4, 1536),
                 ("jamba-v0.1-52b", True, 2, 512),
                 ("xlstm-1.3b", True, 4, 1536))


def phase_decode_scan(torch, dev):
    """Phase 2's selective scan at jamba's decode shape (B 4, L 1, Di
    8,192, S 16, a non-zero carried state h0) against its plain version
    within 1e-4, timed beside the plain version and its bound."""
    from repro_torch.kernels.selective_scan.kernel import plan_selective_scan
    from repro_torch.kernels.selective_scan.ops import selective_scan
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    B, L, Di, S = DECODE_SCAN
    args = scan_inputs(torch, gen, B, L, Di, S)
    err, _ = scan_check(torch, f"decode {DECODE_SCAN}", args)
    launch, _ = plan_selective_scan(*args)
    ms, host, prof = device_ms(torch, launch, SCAN_NAME, 200)
    graph = graph_ms(torch, lambda: plan_selective_scan(*args)[0])
    plain = time_ms(lambda: selective_scan(*args, use_kernel=False), reps=20)
    n_bytes, n_ops = scan_cost(B, L, Di, S)
    bound, by = bound_ms(n_bytes, n_ops, 0.0)
    print(f"[kernels] selective_scan at jamba's decode shape (B {B}, L {L}, "
          f"Di {Di}, S {S}, h0 ~ N(0, 1); {scan_plan_text(launch.plan)}) == "
          f"plain within 1e-4 (max |diff| {err}); kernel {ms} ms (CUDA events "
          f"over 200 back-to-back launches; host enqueue {host} ms), "
          f"{graph} ms (CUDA events over the same 200 launches replayed from "
          f"one CUDA graph), profiler {prof} ms; plain {plain} ms; bound "
          f"{bound} ms ({by}; {n_bytes} bytes) = {bound / ms} of the bound "
          f"by eager events, {bound / graph} by graph events, {bound / prof} "
          f"by the profiler", flush=True)
    return err, dict(shape=list(DECODE_SCAN), ms=ms, graph_ms=graph,
                     profiler_ms=prof, host_ms=host, plain_ms=plain,
                     bound_ms=bound, bound_by=by, plan=launch.plan._asdict())


def decode_vs_prefill(torch, cfg, params, batch, counters, want):
    """prefill(L - 1, pad_to=L) then one decode step of position L - 1,
    against the last position of a prefill of all L positions of
    ``batch`` (token ids, codebook ids or embeddings), through the
    kernels.  Fails unless the decode step launched exactly ``want``;
    returns (max |diff| / max |prefill|, ms of the decode step)."""
    from repro_torch.models.model import make_decode_step, make_prefill_step
    (key, x), = batch.items()
    B, L = x.shape[:2]
    full, _ = make_prefill_step(cfg)(params, batch)
    _, caches = make_prefill_step(cfg, pad_to=L)(params, {key: x[:, :-1]})
    pos = torch.full((B,), L - 1, dtype=torch.int32, device=x.device)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    logits, _ = make_decode_step(cfg)(params, caches,
                                      {key: x[:, -1:].contiguous()}, pos)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check_launches(f"{cfg.name} decode step", counters, want)
    ratio, _ = worst_leaf(cfg.name, logits[:, 0], full)
    return ratio, ms


def phase_decode(torch, dev, counters):
    """Phase 26: ``make_decode_step`` at full width.  For each model of
    DECODE_MODELS, prefill(L - 1) + decode == the prefill of all L
    tokens' last logits: gemma3-1b and xlstm-1.3b in bf16 (within 0.1 of
    the max) and float32 (1e-4); jamba in float32 with the MoE capacity
    raised to hold every token (a decode token is never dropped, a
    prefill token can be), and its bf16 decode through the kernels
    against the plain versions (every returned leaf within 0.1; the plain
    pass on the kernel pass's experts).  The decode step launches
    ``selective_scan_call`` once per Mamba layer and no other kernel.
    Returns the selective-scan launches of the counted decode steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import MAMBA
    from repro_torch.models.model import make_decode_step, make_prefill_step
    scan_launches = 0
    for arch, one_period, B, L in DECODE_MODELS:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if one_period:
            cfg = dataclasses.replace(cfg, n_layers=cfg.period).validate()
        n_mamba = sum(m == MAMBA for m, _ in cfg.layer_specs)
        want = {c.__name__: 0 for c in counters}
        want["selective_scan_call"] = n_mamba
        params, batch = prefill_inputs(torch, dev, cfg, B, SEED + 26)
        tokens = batch["tokens"][:, :L].contiguous()
        ratios = {}
        if cfg.n_experts:
            with RouteReplay() as replay:
                outs = []
                for mode, uk in (("record", None), ("replay", False)):
                    replay.start(mode)
                    _, caches = make_prefill_step(
                        cfg, pad_to=L, use_kernel=uk)(
                            params, {"tokens": tokens[:, :-1]})
                    pos = torch.full((B,), L - 1, dtype=torch.int32,
                                     device=dev)
                    for c in counters:
                        c.launches = 0
                    out = make_decode_step(cfg, use_kernel=uk)(
                        params, caches, {"tokens": tokens[:, -1:]}, pos)
                    torch.cuda.synchronize()
                    if uk is None:
                        got = check_launches(f"{arch} counted decode step",
                                             counters, want)
                        scan_launches += got["selective_scan_call"]
                    outs.append(out)
                    del caches
                if replay.calls != len(replay.recorded):
                    fail(f"{arch}: the plain pass routed {replay.calls} "
                         f"times, the kernel pass {len(replay.recorded)}")
                flips = f"{replay.flips} of {replay.tokens}"
            ratio, path = worst_leaf(
                arch, {"logits": outs[0][0], "caches": outs[0][1]},
                {"logits": outs[1][0], "caches": outs[1][1]})
            if ratio > 0.1:
                fail(f"{arch} bf16 decode: kernels vs plain at {path} read "
                     f"{ratio} of the leaf's max |plain|, above 0.1")
            ratios["bf16 kernels vs plain"] = (ratio, path, flips)
            del outs
        else:
            ratio, ms = decode_vs_prefill(torch, cfg, params,
                                          {"tokens": tokens}, counters, want)
            if ratio > 0.1:
                fail(f"{arch} bf16: decode vs prefill logits read {ratio} of "
                     "the max, above 0.1")
            ratios["bf16 decode vs prefill"] = (ratio, f"{ms} ms decode")
        upcast(torch, params)
        cfg32 = drop_free(dataclasses.replace(cfg, compute_dtype="float32"))
        ratio, ms = decode_vs_prefill(torch, cfg32, params,
                                      {"tokens": tokens}, counters, want)
        if ratio > 1e-4:
            fail(f"{arch} float32: decode vs prefill logits read {ratio} of "
                 "the max, above 1e-4")
        ratios["float32 decode vs prefill"] = (ratio, f"{ms} ms decode")
        del params, batch, tokens
        torch.cuda.empty_cache()
        print(f"[decode] {arch}: {cfg.n_layers} layers at full width, B {B}, "
              f"L {L}; prefill(L - 1) + decode of token L - 1: {ratios} "
              f"(max |diff| / max; gates 0.1 bf16, 1e-4 float32); the "
              f"counted decode launched {want} ; "
              f"{time.perf_counter() - t_arch:.1f} s", flush=True)
    return scan_launches


BATCHER = dict(slots=4, requests=8, max_len=512, greedy_tokens=4,
               timed_tokens=32)


def serve_requests(torch, b, n, max_tokens):
    """Submit ``n`` requests (prompts of three tokens, as the launcher's)
    and decode until drained; returns ({rid: tokens}, wall seconds)."""
    from repro_torch.serving import Request
    for i in range(n):
        b.submit(Request(rid=i, prompt=[2 + i, 7, 11 + i],
                         max_tokens=max_tokens))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = b.run_until_drained()
    torch.cuda.synchronize()
    return {r.rid: r.output for r in done}, time.perf_counter() - t0


def greedy_forward(torch, cfg, params, prompt, n):
    """Plain greedy decoding through ``forward`` over the whole sequence
    each token; returns (tokens, the smallest top-2 logit gap)."""
    from repro_torch.models.model import forward
    toks, gap = list(prompt), float("inf")
    dev = params["final"]["norm"].device
    for _ in range(n):
        lg, _, _ = forward(cfg, params,
                           tokens=torch.tensor([toks], device=dev))
        top = lg[0, -1].float().topk(2).values.tolist()
        gap = min(gap, top[0] - top[1])
        toks.append(int(lg[0, -1].float().argmax()))
    return toks[len(prompt):], gap


def phase_batcher(torch, dev, smi):
    """Phase 27: the continuous batcher on gemma3-1b at its published
    size, 4 slots, 8 requests (each slot serves twice).  In float32 its
    tokens equal greedy decoding through ``forward`` on a well-posed run
    (the reference's smallest top-2 gap above 1e-4).  In bf16, timed: ms
    per tick, tokens/s, CUDA kernels and host synchronisations per tick
    (the profiler's kernel events, ``set_sync_debug_mode("warn")``'s
    warnings), the KV-cache bytes and the tick's memory bound (every
    weight and cache byte read once at the HBM rate).  Then the launcher,
    ``repro_torch.launch.serve.main``, once at full width."""
    import dataclasses
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousBatcher
    t_phase = time.perf_counter()
    cfg = get_config("gemma3-1b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params, _ = prefill_inputs(torch, dev, cfg32, 1, SEED + 27)
    gap, ticks = serve_f32(torch, dev, cfg32, params, BATCHER["slots"],
                           BATCHER["requests"], BATCHER["greedy_tokens"],
                           BATCHER["max_len"])
    print(f"[batcher] gemma3-1b float32, {BATCHER['slots']} slots, "
          f"{BATCHER['requests']} requests x {BATCHER['greedy_tokens']} "
          f"tokens in {ticks} ticks == greedy decoding through forward "
          f"(smallest top-2 gap {gap})", flush=True)
    del params
    torch.cuda.empty_cache()

    params, _ = prefill_inputs(torch, dev, cfg, 1, SEED + 27)
    b = ContinuousBatcher(cfg, params, slots=BATCHER["slots"],
                          max_len=BATCHER["max_len"], device=dev)
    serve_requests(torch, b, BATCHER["slots"], 4)            # warm-up
    ticks0 = b.ticks
    out, wall = serve_requests(torch, b, BATCHER["requests"],
                               BATCHER["timed_tokens"])
    n_ticks = b.ticks - ticks0
    n_tok = sum(len(v) for v in out.values())
    before = b.ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_requests(torch, b, BATCHER["slots"], 6)
    prof_ticks = b.ticks - before
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "Memcpy" not in e.name and "Memset" not in e.name)
    copies = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "Memcpy" in e.name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            before = b.ticks
            serve_requests(torch, b, BATCHER["slots"], 6)
            sync_ticks = b.ticks - before
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    w_bytes = sum(t.numel() * t.element_size() for _, t in leaves(b.params))
    kv = sum(t.numel() * t.element_size() for _, t in leaves(b.caches))
    bound = (w_bytes + kv) / HBM_BYTES_PER_S * 1e3
    ms_tick = wall * 1e3 / n_ticks
    print(f"[batcher] gemma3-1b bf16 on {smi}: {BATCHER['requests']} "
          f"requests x {BATCHER['timed_tokens']} tokens on "
          f"{BATCHER['slots']} slots: {n_ticks} ticks in {wall} s = "
          f"{ms_tick} ms per tick, {n_tok / wall} tokens/s; per tick "
          f"{kernels / prof_ticks} CUDA kernels and {copies / prof_ticks} "
          f"copies (profiler over {prof_ticks} ticks), {syncs / sync_ticks} host"
          f" synchronisations (sync debug mode over {sync_ticks} ticks); "
          f"KV caches {kv} bytes (max_len {BATCHER['max_len']}), weights "
          f"{w_bytes} bytes; the tick's bound {bound} ms (weights and caches"
          f" read once at {HBM_BYTES_PER_S / 1e12} TB/s) = {bound / ms_tick}"
          f" of the tick", flush=True)
    del b, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    done = serve.main(["--arch", "gemma3-1b", "--requests", "8", "--slots",
                       "4", "--max-tokens", "8", "--seed", str(SEED),
                       "--device", str(dev)])
    if len(done) != 8 or any(len(r.output) != 8 for r in done):
        fail(f"launch.serve: {len(done)} requests served")
    torch.cuda.empty_cache()
    print(f"[batcher] repro_torch.launch.serve.main at full width: "
          f"{len(done)} requests in {time.perf_counter() - t0:.1f} s with "
          f"its weight draw; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(ms_per_tick=ms_tick, tokens_per_s=n_tok / wall,
                bound_ms=bound, kernels_per_tick=kernels / prof_ticks,
                syncs_per_tick=syncs / sync_ticks)


# the PRED suite of phase 28: ETL, STATS and PRED tenants in turn (8 PRED
# flows), each raw stream firing with probability 0.25 a trace round
PRED = dict(n_tenants=24, rounds=8, K=4, slots=4, max_len=64)


def pred_percentiles(suite):
    """Nearest-rank p50/p95/p99 (rounds) over the PRED tenants' records."""
    import numpy as np
    tids = [f.tenant.tid for f in suite.flows if f.kind == "pred"]
    h = suite.slo.hist[tids].sum(axis=0)
    total = int(h.sum())
    out = []
    for q in (50, 95, 99):
        rank = max(1, int(np.ceil(q / 100.0 * total)))
        bucket = int(np.searchsorted(np.cumsum(h), rank, side="left"))
        out.append((bucket + 1) * suite.slo.bucket_width - 1)
    return out, total


def run_pred(torch, dev, shards, use_kernel, cfg, params, counters):
    """The PRED suite on ``shards`` shards with a bf16 gemma3-1b batcher
    wired by ``wire_pred``, its decode steps under
    ``torch.use_deterministic_algorithms(True)``; every launch counter 0
    just before ``drive``.
    Returns (suite, drive's result, wall seconds)."""
    from repro_torch.serving import ContinuousBatcher
    from repro_torch.workloads import TraceConfig, build_suite, drive
    from repro_torch.workloads import wire_pred
    suite = build_suite(
        PRED["n_tenants"], n_shards=shards,
        trace=TraceConfig(n_devices=PRED["n_tenants"], rounds=PRED["rounds"],
                          seed=SEED),
        cfg_overrides={"superstep": PRED["K"]}, device=dev,
        use_kernel=use_kernel)
    if suite.engine._path != "fused":
        fail(f"the PRED suite took the {suite.engine._path} path")
    batcher = ContinuousBatcher(cfg, params, slots=PRED["slots"],
                                max_len=PRED["max_len"], device=dev)
    step = batcher._step

    def deterministic_step():
        # the model under deterministic algorithms, so that both engines'
        # batchers compute the same tokens; the engines are bitwise
        # deterministic by design (phases 7 and 11)
        torch.use_deterministic_algorithms(True)
        try:
            return step()
        finally:
            torch.use_deterministic_algorithms(False)
    batcher._step = deterministic_step
    wire_pred(suite, batcher)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = drive(suite, PRED["K"])
    torch.cuda.synchronize()
    return suite, out, time.perf_counter() - t0


def phase_pred(torch, dev, shards, cfg, params, counters, smi):
    """Phase 28 at ``shards`` shards (fused): the suite through the
    kernels and through their plain versions, each with its own batcher
    on the same weights, its decode steps under deterministic algorithms:
    engine state,
    SLO histograms and report, window store, the bridge's completions
    (rids, prompts, outputs) and the response streams bitwise; the round
    kernels once per round."""
    import numpy as np
    tag = f"PRED D={shards}"
    sp, outp, _ = run_pred(torch, dev, shards, False, cfg, params, counters)
    sk, outk, wall = run_pred(torch, dev, shards, None, cfg, params,
                              counters)
    rounds = (PRED["rounds"] + 4) * PRED["K"]
    launches = check_launches(tag, counters,
                              want_launches(rounds, shards, "fused"))
    compare_engines(tag, sk.engine, [], sp.engine, [])
    if not (np.array_equal(sk.slo.hist, sp.slo.hist)
            and np.array_equal(sk.slo.violations, sp.slo.violations)
            and outk["slo_report"] == outp["slo_report"]
            and outk["records"] == outp["records"] > 0):
        fail(f"{tag}: SLO histograms or report differ")
    for f in sk.stats.store._fields:
        compare(f"{tag} window store {f}", getattr(sk.stats.store, f),
                getattr(sp.stats.store, f))

    def done(s):
        return [(r.rid, [int(t) for t in r.prompt], r.output)
                for r in s.bridge.completed]
    if done(sk) != done(sp) or not done(sk):
        fail(f"{tag}: bridge completions differ or none completed")
    for f in (f for f in sk.flows if f.kind == "pred"):
        compare(f"{tag} response {f.response.name}",
                torch.from_numpy(np.asarray(sk.engine.value_of(f.response))),
                torch.from_numpy(np.asarray(sp.engine.value_of(f.response))))
    (p50, p95, p99), n_pred = pred_percentiles(sk)
    b = sk.bridge.batcher
    print(f"[{tag}] {PRED['n_tenants']} tenants (ETL, STATS, PRED), "
          f"{sk.registry.n_active} streams, {PRED['rounds']} trace rounds + "
          f"4 in supersteps of K={PRED['K']}: kernels == plain bitwise "
          f"(state, SLO histograms and report, window store, "
          f"{len(sk.bridge.completed)} completions, response streams); "
          f"launches {launches}; PRED latency p50/p95/p99 {p50}/{p95}/{p99} "
          f"rounds over {n_pred} records (all tenants "
          f"{outk['slo_report']['total']['p50']}/"
          f"{outk['slo_report']['total']['p95']}/"
          f"{outk['slo_report']['total']['p99']}); {sk.bridge._next_rid} "
          f"requests, {b.ticks} ticks; drive() wall {wall} s on {smi}",
          flush=True)
    return dict(p50=p50, p95=p95, p99=p99, requests=sk.bridge._next_rid,
                ticks=b.ticks, wall_s=wall)


# --------------------------------------------------------------------------
# phase 29: the seven other architectures (prefill, decode, serving)
# --------------------------------------------------------------------------

# (arch, layers kept (None: the published depth), decode L).  mistral-large
# (245 GB in bf16) and qwen2-vl (143 GB) keep 16 and 24 layers, ~46 and
# ~45 GB; decode L 1,536 lets gemma3-27b's 1,024-slot local rings wrap,
# 512 keeps an MoE model's dispatch groups (min(512, L) tokens) dividing
# both L and L - 1
ARCHS_29 = (("gemma3-27b", None, 1536), ("deepseek-moe-16b", None, 512),
            ("qwen2-moe-a2.7b", None, 512), ("minitron-8b", None, 1024),
            ("musicgen-large", None, 1024), ("mistral-large-123b", 16, 1024),
            ("qwen2-vl-72b", 24, 1024))
SERVE_29 = dict(slots=4, requests=4, max_len=64, greedy_tokens=3,
                timed_tokens=8)


def cut_copy(cfg):
    """``cfg`` cut to its prefix layers and its first period (two layers
    where the period is one, so that the scan stacks two), in float32."""
    import dataclasses
    n = len(cfg.prefix) + cfg.period * (2 if cfg.period == 1 else 1)
    return dataclasses.replace(cfg, n_layers=n,
                               compute_dtype="float32").validate()


def drop_free(cfg):
    """``cfg`` with the MoE capacity raised to hold every token of a
    group (a decode token is never dropped; a prefill token can be)."""
    import dataclasses
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


def replayed_pair(torch, cfg, params, batch, counters, want, tag):
    """The prefill through the kernels (every launch counter 0 just
    before it), then through the plain versions on the kernel pass's
    experts (``RouteReplay.paired``); the plain pass launches no kernel,
    so the counts read after it are the kernel pass's, checked against
    ``want``.  Returns (worst leaf ratio, its path, the tokens routed
    otherwise, the counts read)."""
    from repro_torch.models.model import make_prefill_step
    for c in counters:
        c.launches = 0
    with RouteReplay() as replay:
        out_k, out_p, flips = replay.paired(
            make_prefill_step(cfg), make_prefill_step(cfg, use_kernel=False),
            params, batch, "replay")
    torch.cuda.synchronize()
    got = check_launches(tag, counters, want)
    ratio, path = worst_leaf(tag, {"logits": out_k[0], "caches": out_k[1]},
                             {"logits": out_p[0], "caches": out_p[1]})
    return ratio, path, flips, got


def serve_f32(torch, dev, cfg, params, slots, n, k, max_len):
    """The batcher (``slots`` slots, ``n`` requests of three-token
    prompts, ``k`` tokens each) against greedy decoding through
    ``forward``; the greedy reference runs first and its smallest top-2
    logit gap must be above 1e-4 (a well-posed run) before the tokens are
    compared.  Returns (that gap, the batcher's ticks)."""
    from repro_torch.serving import ContinuousBatcher
    b = ContinuousBatcher(cfg, params, slots=slots, max_len=max_len,
                          device=dev)
    want, gaps = {}, []
    for i in range(n):
        want[i], gap = greedy_forward(torch, cfg, b.params,
                                      [2 + i, 7, 11 + i], k)
        gaps.append(gap)
    if min(gaps) <= 1e-4:
        fail(f"{cfg.name} batcher float32: the greedy reference's smallest "
             f"top-2 gap {min(gaps)} is not above 1e-4 (not well posed)")
    got, _ = serve_requests(torch, b, n, k)
    if got != want:
        fail(f"{cfg.name} batcher float32: decoded {got}, greedy forward "
             f"{want}")
    return min(gaps), b.ticks


def serve_bf16(torch, dev, cfg, params):
    """One timed bf16 batcher run: (ms per tick, tokens/s, ticks)."""
    from repro_torch.serving import ContinuousBatcher
    b = ContinuousBatcher(cfg, params, slots=SERVE_29["slots"],
                          max_len=SERVE_29["max_len"], device=dev)
    serve_requests(torch, b, SERVE_29["slots"], 2)                # warm-up
    ticks0 = b.ticks
    out, wall = serve_requests(torch, b, SERVE_29["requests"],
                               SERVE_29["timed_tokens"])
    n_tok = sum(len(v) for v in out.values())
    if n_tok != SERVE_29["requests"] * SERVE_29["timed_tokens"]:
        fail(f"{cfg.name} batcher bf16: {n_tok} tokens served")
    n_ticks = b.ticks - ticks0
    return wall * 1e3 / n_ticks, n_tok / wall, n_ticks


def phase_arch(torch, dev, arch, n_layers, L_dec, counters, smi):
    """Phase 29 for one architecture (see the module docstring): the bf16
    prefill at the run depth through the kernels (launches counted) and
    through the plain versions; the float32 cut copy kernels against
    plain; decode against the full prefill in both; the batchers and the
    launcher for a text model, the launcher's refusal for a modality
    model.  Returns the ``flash_attention_call`` launches of the counted
    bf16 prefill, as read from its counter."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.config import ATTN, ATTN_LOCAL
    from repro_torch.models.model import count_params, make_prefill_step
    t_arch = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers).validate() \
        if n_layers else full
    text = cfg.n_codebooks == 1 and not cfg.embed_inputs
    n_attn = sum(m in (ATTN, ATTN_LOCAL) for m, _ in cfg.layer_specs)
    none = {c.__name__: 0 for c in counters}
    want = dict(none, flash_attention_call=n_attn)
    seed = SEED + 29
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, batch = prefill_inputs(torch, dev, cfg, 1, seed)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
    draw_peak = torch.cuda.max_memory_allocated()
    cut = (f"{cfg.n_layers} of the published {full.n_layers} layers (all "
           f"{full.n_layers}: {count_params(full) * 2} bytes in bf16, past "
           f"the card's memory)" if n_layers else
           f"{cfg.n_layers} layers, the published depth")
    (key, x), = batch.items()
    print(f"[{arch}] {cut}, full width (d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads}, Dh {cfg.d_head}); {count_params(cfg)}"
          f" parameters, {n_bytes} bytes on the card ({cfg.compute_dtype}), "
          f"drawn in {t_draw:.2f} s at a peak of {draw_peak} bytes; input "
          f"{key} {tuple(x.shape)} {x.dtype}", flush=True)

    ratio, path, flips, got = replayed_pair(torch, cfg, params, batch,
                                            counters, want,
                                            f"{arch} bf16 prefill")
    launches = got["flash_attention_call"]
    if ratio > 0.1:
        fail(f"{arch} bf16: kernels vs plain at {path} read {ratio} of the "
             "leaf's max |plain|, above 0.1")
    ms, peak = timed_prefill(torch, make_prefill_step(cfg), params, batch, 1)
    print(f"[{arch}] bf16 prefill B 1, L {x.shape[1]}: flash_attention_call "
          f"launched {launches} times (its {n_attn} attention layers; no "
          f"other kernel) "
          f"in the counted run; kernels vs plain (the plain pass on the "
          f"kernel pass's experts; tokens routed otherwise {flips}) worst "
          f"leaf max |diff| / max |plain| = {ratio} ({path}; gate 0.1); "
          f"{ms} ms per prefill (one run after the counted one), "
          f"{PROMPT / ms * 1e3} prompt tokens/s, max_memory_allocated "
          f"{peak} bytes on {smi}", flush=True)

    dcfg = drop_free(cfg)
    dbatch = model_batch(torch, dev, cfg, 2, L_dec, seed + 1)
    ratio, ms = decode_vs_prefill(torch, dcfg, params, dbatch, counters, none)
    if ratio > 0.1:
        fail(f"{arch} bf16: decode vs prefill logits read {ratio} of the "
             "max, above 0.1")
    print(f"[{arch}] bf16 decode at {cfg.n_layers} layers (B 2, L {L_dec}"
          f"{', capacity raised' if cfg.n_experts else ''}): prefill(L - 1) +"
          f" one decode step vs the prefill of L, last logits max |diff| / "
          f"max = {ratio} (gate 0.1); the decode step {ms} ms (synchronised,"
          f" its first call), no kernel launched", flush=True)
    del dbatch
    if text:
        ms_tick, tok_s, ticks = serve_bf16(torch, dev, cfg, params)
        print(f"[{arch}] batcher bf16 at {cfg.n_layers} layers, "
              f"{SERVE_29['slots']} slots: {SERVE_29['requests']} requests x"
              f" {SERVE_29['timed_tokens']} tokens in {ticks} ticks, "
              f"{ms_tick} ms per tick, {tok_s} tokens/s on {smi}", flush=True)
    del params, batch
    torch.cuda.empty_cache()

    if text and not n_layers:
        t0 = time.perf_counter()
        done = serve.main(["--arch", arch, "--requests", "2", "--slots", "2",
                           "--max-tokens", "2", "--max-len", "16", "--seed",
                           str(SEED), "--device", str(dev)])
        if len(done) != 2 or any(len(r.output) != 2 for r in done):
            fail(f"{arch} launch.serve: {len(done)} requests served")
        torch.cuda.empty_cache()
        print(f"[{arch}] launch.serve.main at the published size: 2 "
              f"requests in {time.perf_counter() - t0:.1f} s with its weight "
              "draw", flush=True)
    elif text:
        print(f"[{arch}] launch.serve.main not run: it draws all "
              f"{full.n_layers} layers, past the card's memory", flush=True)
    else:
        try:
            serve.main(["--arch", arch, "--device", str(dev)])
        except SystemExit as e:
            print(f"[{arch}] launch.serve.main refused: {e}", flush=True)
        else:
            fail(f"launch.serve.main served {arch}, a modality-frontend arch")

    cfg32 = cut_copy(full)
    params, batch = prefill_inputs(torch, dev, cfg32, 1, seed)
    ratio, path, flips, _ = replayed_pair(
        torch, cfg32, params, batch, counters,
        dict(none, flash_attention_call=sum(m in (ATTN, ATTN_LOCAL)
                                            for m, _ in cfg32.layer_specs)),
        f"{arch} float32 prefill")
    if ratio > 1e-4:
        fail(f"{arch} float32: kernels vs plain at {path} read {ratio} of "
             "the leaf's max |plain|, above 1e-4")
    del batch
    dcfg = drop_free(cfg32)
    d_ratio, d_ms = decode_vs_prefill(
        torch, dcfg, params, model_batch(torch, dev, cfg32, 2, L_dec,
                                         seed + 1), counters, none)
    if d_ratio > 1e-4:
        fail(f"{arch} float32: decode vs prefill logits read {d_ratio} of "
             "the max, above 1e-4")
    if text:
        gap, _ = serve_f32(torch, dev, dcfg, params, 2,
                           SERVE_29["requests"] - 1, SERVE_29["greedy_tokens"],
                           SERVE_29["max_len"])
    print(f"[{arch}] float32 copy cut to {cfg32.n_layers} layers "
          f"({len(cfg32.prefix)} prefix + {cfg32.n_layers - len(cfg32.prefix)}"
          f" of the pattern), drawn in float32: prefill B 1, L {PROMPT} "
          f"kernels vs plain (tokens routed otherwise {flips}) worst leaf "
          f"{ratio} ({path}; gate 1e-4); decode vs prefill (B 2, L {L_dec}) "
          f"{d_ratio} (gate 1e-4), the decode step {d_ms} ms"
          + (f"; the batcher (2 slots, {SERVE_29['requests'] - 1} requests x "
             f"{SERVE_29['greedy_tokens']} tokens) == greedy decoding "
             f"through forward (smallest top-2 gap {gap})" if text else "")
          + f"; {time.perf_counter() - t_arch:.1f} s for {arch}", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def engine_counters() -> tuple:
    """The launch-counted wrappers of the engine's round kernels."""
    from repro_torch.kernels.round_fuse.kernel import (apply_programs_call,
                                                       exchange_compact_call,
                                                       fused_round_call)
    from repro_torch.kernels.sched_pop.kernel import sched_pop_call
    from repro_torch.kernels.stream_dispatch.kernel import (
        by_sid_snapshot_call, onehot_gather_call, stream_dispatch_call)
    from repro_torch.kernels.window_agg.kernel import window_agg_call
    return (fused_round_call, sched_pop_call, window_agg_call,
            apply_programs_call, exchange_compact_call, stream_dispatch_call,
            onehot_gather_call, by_sid_snapshot_call)


def stamp(phase: str, t_start: float) -> None:
    """The run's elapsed seconds as ``phase`` starts (the budget's ledger)."""
    print(f"[time] phase {phase} starts at {time.perf_counter() - t_start:.1f}"
          " s", flush=True)


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
    # phase 28 runs the model under torch.use_deterministic_algorithms,
    # which needs cuBLAS's workspace fixed before CUDA starts
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.round_fuse.kernel import (apply_programs_call,
                                                       fused_round_call)
    from repro_torch.kernels.sched_pop.kernel import sched_pop_call
    from repro_torch.kernels.flash_attention.kernel import flash_attention_call
    from repro_torch.kernels.selective_scan.kernel import selective_scan_call
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunkwise_call

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. build -------------------------------------------------------
    probe = start_probe_build()
    fmad = start_fmad_build()
    libs = _build.build_all(verbose_ptxas=True)
    print(f"[build] {len(_build.sources())} CUDA sources built with nvcc "
          f"into {_build.BUILD_DIR.relative_to(ROOT)} in "
          f"{_build.build_seconds:.2f} s", flush=True)
    for stem, log in _build.build_log.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Performance" in line:
                print(f"[build] {stem}: {line.strip()}", flush=True)
    fa_build = attention_build_report(libs["flash_attention"])
    mlstm_build = mlstm_build_report(libs["mlstm_chunk"])
    scan_build = scan_build_report(libs["selective_scan"])
    smi = nvidia_smi()
    clock_hz = max_sm_clock_hz()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}; maximum "
          f"SM clock {clock_hz / 1e6} MHz", flush=True)
    dep_cycles = run_probe(torch, *probe)
    print(f"[probe] {dep_cycles} SM cycles per dependent integer "
          f"instruction", flush=True)

    stamp("2", t_start)
    # ---- 2. kernels against their plain versions -----------------------
    cfg = EngineConfig(n_streams=4096).validate()
    errs = phase_kernels(torch, dev, cfg)
    errs.update(phase_shard_kernels(torch, dev, cfg, SHARDS))
    errs.update(phase_dispatch_kernels(torch, dev, cfg, SHARDS))
    scan_decode_err, scan_decode = phase_decode_scan(torch, dev)

    stamp("3", t_start)
    # ---- 3. fused main path at full width ------------------------------
    import numpy as np
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    reg, sources = build_registry(cfg, rng)
    print(f"[registry] {reg.n_active} streams ({len(sources)} sources) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reg_fused = copy_registry(reg)          # before phase 5 adds tanh
    counters = engine_counters()
    eng, fr_launches, _ = phase_path(torch, dev, reg, sources, "fused", 48,
                                     8, fused_round_call, counters)

    stamp("4", t_start)
    # ---- 4. fused supersteps against eager rounds ----------------------
    phase_superstep(torch, dev, reg, sources, "fused", 8, 6,
                    fused_round_call, counters)

    stamp("5", t_start)
    # ---- 5. staged main path: one tanh composite flips it --------------
    reg.create_composite(reg.tenants[0], "hot", CHANNELS, sources[:2],
                         {ch: f"tanh(in0.{ch}) + in1.{ch}" for ch in CHANNELS})
    _, sp_launches, _ = phase_path(torch, dev, reg, sources, "staged", 16,
                                   4, sched_pop_call, counters)

    stamp("6", t_start)
    # ---- 6. staged supersteps against eager rounds ---------------------
    phase_superstep(torch, dev, reg, sources, "staged", 8, 2,
                    sched_pop_call, counters)

    stamp("7", t_start)
    # ---- 7. the IoT suite at full width, kernels against plain ---------
    suite, suite_launches = phase_suite(torch, dev, counters)

    stamp("8", t_start)
    # ---- 8. sharded fused round, churned, kernels against plain and the
    #         single-device engine --------------------------------------
    e_sh, sh_launches, _ = phase_sharded(torch, dev, reg_fused, sources,
                                         "fused", counters, waves=6,
                                         heavy=24, warm=8)

    stamp("9", t_start)
    # ---- 9. sharded fused supersteps against eager sharded rounds ------
    phase_superstep(torch, dev, copy_registry(reg_fused, n_shards=SHARDS,
                                              exchange_slots=0),
                    sources, "fused", 8, 3, apply_programs_call, counters)

    stamp("10", t_start)
    # ---- 10. sharded staged round, churned, kernels against plain ------
    phase_sharded(torch, dev, reg, sources, "staged", counters, waves=3,
                  heavy=16, warm=8)

    stamp("11", t_start)
    # ---- 11. the IoT suite at D = SHARDS against D = 1, and at full
    #          width on D = SHARDS, kernels against plain ----------------
    phase_shard_suite(torch, dev, counters)
    phase_suite(torch, dev, counters, n_shards=SHARDS)

    stamp("12", t_start)
    # ---- 12. the engine with the stream-dispatch fan-out, kernel against
    #          plain and against fanout_reference --------------------------
    t0 = time.perf_counter()
    d_launches, d_engines = phase_dispatch(torch, dev, reg, reg_fused,
                                           sources, counters)
    print(f"[dispatch] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)

    stamp("13", t_start)
    # ---- 13. timings -----------------------------------------------------
    rows = phase_timings(torch, eng, errs, {"sched_pop": sp_launches,
                                            "fused_round": fr_launches},
                         dep_cycles, clock_hz)
    rows.append(time_window_agg(torch, suite, errs,
                                suite_launches["window_agg_call"]))
    rows += time_shard_kernels(torch, e_sh, sources, errs, sh_launches,
                               dep_cycles, clock_hz)
    d_runs = d_launches.values()
    rows += time_dispatch_kernels(
        torch, d_engines["single staged"], d_engines[f"{SHARDS}-shard fused"],
        sources, errs, {
            "stream_dispatch": sum(r["stream_dispatch_call"] for r in d_runs),
            "onehot_gather": sum(r["onehot_gather_call"]
                                 + r["by_sid_snapshot_call"] for r in d_runs)},
        probe[1])
    stamp("14", t_start)
    # ---- 14. the model kernels against their plain versions ---------------
    del eng, suite, e_sh, d_engines         # the engines' device memory
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in full
    torch.backends.cudnn.allow_tf32 = False         # precision (the defaults)
    m_errs = phase_model_kernels(torch, dev)

    stamp("15-16", t_start)
    # ---- 15-16. prefill of gemma3-1b and jamba-v0.1-52b at full width ----
    m_counters = counters + (flash_attention_call, selective_scan_call)
    m_launches = {"flash_attention_call": 0, "selective_scan_call": 0}
    for arch, n_layers, B in PREFILL_MODELS:
        for k, n in phase_prefill(torch, dev, arch, n_layers, B,
                                  m_counters).items():
            m_launches[k] += n

    stamp("17", t_start)
    # ---- 17. timings of the model kernels -----------------------------------
    rows += time_model_kernels(torch, dev, m_errs, m_launches, fa_build,
                               scan_build)

    stamp("18", t_start)
    # ---- 18. mlstm_chunkwise against its plain version and the oracle --------
    mlstm_err = phase_mlstm_kernel(torch, dev)

    stamp("19-20", t_start)
    # ---- 19-20. the xLSTM prefill at full width: G2, G1 at full width, G3 -----
    x_launches, x_err, _, mlstm_inputs_at = phase_xlstm(
        torch, dev, m_counters + (mlstm_chunkwise_call,))

    stamp("21", t_start)
    # ---- 21. timings of mlstm_chunkwise and the sLSTM scan -------------------
    rows.append(time_mlstm(torch, mlstm_inputs_at, max(mlstm_err, x_err),
                           x_launches, mlstm_build, fmad))

    stamp("22", t_start)
    # ---- 22. kill and resume from checkpoints ---------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ms_restores = [phase_kill_resume(torch, dev, r, sources, shards,
                                     counters, smi)
                   for r, shards in ((reg_fused, 1), (reg, 1),
                                     (reg_fused, SHARDS))]

    stamp("23", t_start)
    # ---- 23. replay and redelivery, kernels against plain ---------------
    for shards in (1, SHARDS):
        phase_redelivery(torch, dev, reg_fused, sources, shards, counters)

    stamp("24", t_start)
    # ---- 24. the resize chain and the autoscaler -------------------------
    phase_elastic(torch, dev, reg_fused, sources, counters, smi)
    print(f"[durability] phases 22-24 took {time.perf_counter() - t0:.1f} s",
          flush=True)

    stamp("25", t_start)
    # ---- 25. the chaos drill under the supervisor -------------------------
    t0 = time.perf_counter()
    for shards in (1, SHARDS):
        phase_chaos(torch, dev, reg_fused, sources, shards, counters, smi,
                    ms_restores)
    print(f"[chaos] phase 25 took {time.perf_counter() - t0:.1f} s",
          flush=True)

    stamp("26", t_start)
    # ---- 26. the decode step at full width ------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scan_launches = phase_decode(torch, dev,
                                 m_counters + (mlstm_chunkwise_call,))
    t26 = time.perf_counter() - t0
    for row in rows:
        if row["name"] == "selective_scan":
            row["launches"] += scan_launches
            row["max_abs_err"] = max(row["max_abs_err"], scan_decode_err)
            row["decode"] = dict(scan_decode, launches=scan_launches)

    stamp("27", t_start)
    # ---- 27. the continuous batcher at full width -------------------------
    t0 = time.perf_counter()
    phase_batcher(torch, dev, smi)
    t27 = time.perf_counter() - t0

    stamp("28", t_start)
    # ---- 28. PRED flows through the serving bridge ------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    g3 = get_config("gemma3-1b")
    g3_params, _ = prefill_inputs(torch, dev, g3, 1, SEED + 28)
    for shards in (1, SHARDS):
        phase_pred(torch, dev, shards, g3, g3_params, counters, smi)
    del g3_params
    print(f"[serving] phases 26, 27, 28 took {t26:.1f}, {t27:.1f}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 29. the seven other architectures at full width -----------------
    t0 = time.perf_counter()
    gc.collect()            # the earlier phases' engines hold cycles
    torch.cuda.empty_cache()
    print(f"[time] phase 29 starts with {torch.cuda.memory_allocated()} "
          "bytes allocated on the card", flush=True)
    per_arch = {}
    for arch, n_layers, L_dec in ARCHS_29:
        stamp(f"29 {arch}", t_start)
        per_arch[arch] = phase_arch(torch, dev, arch, n_layers, L_dec,
                                    m_counters + (mlstm_chunkwise_call,), smi)
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches"] += sum(per_arch.values())
            row["archs"] = per_arch     # each model's counted launches
    print(f"[time] phase 29 (seven architectures) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
