"""The port's CUDA kernels on the card (marker ``cuda``; these skip
without a CUDA device).  Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit against its plain torch version at small
shapes, and a whole engine history on the card (kernels) against the same
history on the CPU (plain versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import EngineConfig, Registry, create_engine  # noqa: E402
from repro_torch.kernels.round_fuse import ref as rf_ref  # noqa: E402
from repro_torch.kernels.round_fuse.kernel import fused_round_call  # noqa: E402
from repro_torch.kernels.round_fuse.ops import fused_stages  # noqa: E402
from repro_torch.kernels.sched_pop.kernel import sched_pop_call  # noqa: E402
from repro_torch.kernels.sched_pop.ops import sched_pop  # noqa: E402
from repro_torch.kernels.selective_scan.kernel import RING_STEPS  # noqa: E402
from model_batches import batch_np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(x):
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got, want):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _assert_bits(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _queue(rng, Q, C, T, N, kind="mixed"):
    """Queue planes (prio, seq, valid, tenant, w_slot, sid, vals, ts) with
    ``w_slot = weight[tenant]``; ``kind`` picks an edge of the sorted
    selection: "invalid" (no valid slot), "int_max" (valid slots at
    priority 2**31 - 1 beside invalid ones of equal seq), "negative"
    (negative priorities and seqs tied across tenants)."""
    vals = rng.standard_normal((Q, C)).astype(np.float32)
    vals.ravel()[rng.integers(0, Q * C, 3)] = [np.nan, -0.0, np.inf]
    tenant = rng.integers(0, T, Q).astype(np.int32)
    prio = rng.choice([0, 1, -2, 2**31 - 1], Q).astype(np.int32)
    seq = rng.integers(-3, 20, Q).astype(np.int32)
    valid = rng.random(Q) < 0.7
    if kind == "invalid":
        valid[:] = False
    if kind == "int_max":
        prio = np.where(rng.random(Q) < 0.8, 2**31 - 1, 1).astype(np.int32)
        seq = rng.integers(0, 3, Q).astype(np.int32)
    if kind == "negative":
        prio = rng.choice([-5, -2], Q).astype(np.int32)
        seq = rng.integers(-3, -1, Q).astype(np.int32)
    return [prio, seq, valid, tenant,
            rng.choice([0, 1, 5, 1 << 15], T).astype(np.int32)[tenant],
            rng.integers(0, N + 3, Q).astype(np.int32), vals,
            rng.integers(-9, 9, Q).astype(np.int32)]


# the edges of the sorted selection: B == Q, no valid slot, queues that are
# no power of two, one tenant, 1,024 tenants, INT_MAX priorities beside
# invalid slots, negative ties, and the largest queues check_fits admits
POP_EDGES = [(200, 200, 5, "mixed"), (300, 64, 4, "invalid"),
             (2047, 64, 16, "mixed"), (2049, 64, 16, "mixed"),
             (500, 64, 1, "mixed"), (2048, 64, 1024, "mixed"),
             (256, 64, 6, "int_max"), (256, 64, 8, "negative"),
             (11050, 64, 16, "mixed"), (9292, 9292, 16, "mixed")]


@pytest.mark.parametrize("Q,B,C,T,kind", [
    (5, 3, 1, 3, "mixed"), (100, 16, 3, 3, "mixed"),
    (2048, 64, 4, 3, "mixed")] + [(Q, B, 2, T, kind)
                                  for Q, B, T, kind in POP_EDGES])
def test_sched_pop_kernel_matches_plain(dev, Q, B, C, T, kind):
    rng = np.random.default_rng(Q)
    prio, seq, valid, tenant, w, sid, vals, ts = (
        torch.from_numpy(a).to(dev) for a in _queue(rng, Q, C, T, 64, kind))
    got = sched_pop_call(prio, seq, valid, tenant, w, sid, vals, ts, B)
    want = sched_pop(prio, seq, valid, tenant, w, sid, vals, ts, B,
                     use_kernel=False)
    _assert_bits(got, want)


# the last rows run the apply's program edges (see _programs) on the fused
# round's per-event planes (rep = F items per event)
@pytest.mark.parametrize("Q,N,C,B,F,M,L,T,kind", [
    (32, 16, 1, 2, 2, 2, 4, 4, "mixed"),
    (200, 40, 4, 8, 3, 4, 12, 4, "mixed"),
    (300, 200, 3, 16, 9, 5, 20, 4, "mixed")] + [
    (Q, 40, 2, B, 3, 4, 12, T, kind) for Q, B, T, kind in POP_EDGES] + [
    (256, 300, 4, 32, 16, 6, 14, 4, prog) for prog in ("tail", "diverse",
                                                       "nop")] + [
    (256, 300, 1, 20, 7, 3, 9, 4, "tail")])
def test_fused_round_kernel_matches_plain(dev, Q, N, C, B, F, M, L, T, kind):
    rng = np.random.default_rng(Q + N)
    prog = kind if kind in ("tail", "diverse", "nop") else None
    kind = "mixed" if prog else kind
    cfg = EngineConfig(n_streams=N, channels=C, max_in=M, max_out=F,
                       batch=B, queue=Q, prog_len=L, n_consts=6, n_temps=4)
    layout = rf_ref.RegLayout.from_cfg(cfg)
    R = layout.n_regs
    pool = np.asarray(sorted(rf_ref.FUSABLE_OPS), np.int32)
    values = rng.standard_normal((N, C)).astype(np.float32)
    values.ravel()[rng.integers(0, N * C, 3)] = [np.nan, -0.0, 1e-40]
    tables = [rng.integers(-1, N, (N, F)).astype(np.int32),
              rng.integers(-2, N, (N, M)).astype(np.int32),
              np.stack([rng.choice(pool, (N, L)),
                        rng.integers(-2, R + 4, (N, L)),
                        rng.integers(-2, R + 4, (N, L)),
                        rng.integers(-2, R + 4, (N, L))],
                       axis=-1).astype(np.int32) if prog is None else
              _programs(rng, (N,), L, R, prog),
              rng.standard_normal((N, 6)).astype(np.float32),
              rng.random(N) < 0.7, rng.random(N) < 0.85, values,
              rng.integers(-5, 30, N).astype(np.int32)]
    q = [torch.from_numpy(a).to(dev) for a in _queue(rng, Q, C, T, N, kind)]
    t = [torch.from_numpy(a).to(dev) for a in tables]
    before = fused_round_call.launches
    got = fused_round_call(*q, B, *t, layout)
    assert fused_round_call.launches == before + 1
    _assert_bits(got, fused_stages(*q, B, *t, layout, use_kernel=False))


def _engine(device, fused):
    cfg = EngineConfig(n_streams=64, n_tenants=4, channels=3, max_in=4,
                       max_out=4, batch=8, queue=32, prog_len=16, n_consts=8,
                       n_temps=8, sink_buffer=32, dlq_slots=16,
                       retention_slots=2, fused_round=fused,
                       fault_threshold=2)
    reg = Registry(cfg)
    t0, t1 = reg.create_tenant("a"), reg.create_tenant("b")
    srcs = [reg.create_stream(t0, f"s{i}", ["x", "y", "z"]) for i in range(6)]
    c0 = reg.create_composite(t0, "c0", ["x", "y", "z"], srcs[:3],
                              {"x": "s0.x + s1.y", "y": "out.y + 1",
                               "z": "min(s2.z, 4.0)"},
                              post_filter="out.x < 100")
    reg.create_composite(t1, "c1", ["x", "y", "z"], [srcs[3], c0],
                         {"x": "c0.x * 2", "y": "s3.y - c0.z",
                          "z": "sign(s3.z) / (s3.x - 0.5)"})
    eng = create_engine(reg, device=device)
    eng.set_weight(t0, 3)
    eng.set_quota(t1, 4, burst=6)
    return eng, srcs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_engine_on_the_card_equals_the_cpu(dev, fused):
    """The kernels on the card and the plain versions on the CPU give the
    same history, bit for bit."""
    eg, srcs = _engine(dev, fused)
    ec, _ = _engine("cpu", fused)
    rng = np.random.default_rng(8)
    for r in range(10):
        for s in srcs:
            v = rng.standard_normal(3).astype(np.float32)
            if r % 4 == 1:
                v[0] = np.nan
            t = r * 10 + int(rng.integers(0, 9))
            eg.post(s, v.tolist(), t)
            ec.post(s, v.tolist(), t)
        _assert_bits(tuple(eg.round()), tuple(ec.round()))
        for f in eg.state._fields:
            if f == "stats":
                for k in eg.state.stats:
                    _assert_bits(eg.state.stats[k], ec.state.stats[k])
            else:
                _assert_bits(getattr(eg.state, f), getattr(ec.state, f))


@pytest.mark.parametrize("W,C", [(1, 1), (8, 4), (33, 1), (256, 4),
                                 (1, 4), (5, 3), (7, 5), (33, 4), (64, 5),
                                 (1024, 1), (1024, 3), (1024, 4), (8, 40)])
@pytest.mark.parametrize("offset", [0, 1])
def test_window_agg_kernel_matches_plain(dev, W, C, offset):
    """Bitwise against the plain version on both stagings: bulk copies on
    an aligned store where W C % 4 == 0, and 4-byte copies where W C % 4
    != 0 and on a view that starts ``offset`` floats into its buffer.  N
    a multiple of no warp's streams, counts of 0, W and in between,
    -0.0, NaN (canonical and with payloads), infinities, subnormals, and
    windows of zeros alternating in sign (the order of -0.0 below
    +0.0)."""
    from repro_torch.kernels.window_agg.kernel import (window_agg_call,
                                                       window_agg_plan)
    from repro_torch.kernels.window_agg.ops import window_agg
    rng = np.random.default_rng(W + C)
    N = 37                              # not a multiple of a warp's streams
    v = (rng.standard_normal((N, W, C)) * 10).astype(np.float32)
    flat = v.reshape(-1)
    flat[rng.integers(0, v.size, 6)] = -0.0
    flat[rng.integers(0, v.size, 6)] = 1e-40
    flat[rng.integers(0, v.size, 4)] = np.array(
        [0x7fc12345, 0xffa00001, 0x7f800000, 0xff800000],
        np.uint32).view(np.float32)     # NaN payloads, infinities
    v[2, 0, 0] = np.nan
    sign = (np.arange(W) % 2 == 1)[:, None]
    v[3] = np.where(sign, 0.0, -0.0)    # zeros alternating in sign
    v[4] = np.where(sign, -0.0, 0.0)
    count = rng.integers(0, W + 1, N).astype(np.int32)
    count[0], count[1], count[3], count[4] = 0, W, W, W
    buf = torch.empty(v.size + offset, device=dev)
    values = buf[offset:].view(N, W, C)
    values.copy_(torch.from_numpy(v))
    cnt = torch.from_numpy(count).to(dev)
    plan = window_agg_plan(N, W, C, values.data_ptr() % 16 == 0)
    assert plan.staging == ("bulk" if offset == 0 and (W * C) % 4 == 0
                            else "load4")
    before = window_agg_call.launches
    got = window_agg_call(values, cnt)
    assert window_agg_call.launches == before + 1
    want = window_agg(values, cnt, use_kernel=False)
    for k in want:
        _assert_bits(got[k], want[k])


def _superstep_engine(device, fused, **kw):
    from repro_torch.core import EngineConfig as Cfg
    cfg = Cfg(n_streams=16, n_tenants=4, batch=8, queue=64, max_in=4,
              max_out=4, prog_len=24, n_temps=12, dlq_slots=8,
              fused_round=fused, **kw)
    reg = Registry.with_capacity(cfg)
    t = reg.create_tenant("t")
    srcs = [reg.create_stream(t, f"s{i}", ["v"]) for i in range(4)]
    c0 = reg.create_composite(t, "c0", ["v"], [srcs[0]], {"v": "in0.v + 1"})
    c1 = reg.create_composite(t, "c1", ["v"], [srcs[0], srcs[1]],
                              {"v": "in0.v + in1.v * 2"})
    reg.create_composite(t, "c2", ["v"], [srcs[2]], {"v": "in0.v * 3"},
                         post_filter="out.v < 1e6")
    reg.create_composite(t, "c3", ["v"], [c0, c1], {"v": "in0.v - in1.v"})
    eng = create_engine(reg, device=device)
    for w in range(3):
        for i, s in enumerate(srcs):
            eng.post(s, [float(10 * w + i)], 8 * w + 1)
        for b in range(5):
            eng.post(srcs[2], [float(100 * w + b)], 8 * w + 3 + b)
    return eng


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_superstep_on_the_card_equals_rounds(dev, fused):
    """Two supersteps of K = 3 on the card, their K rounds under the sync
    debug mode (no host synchronisation), equal six rounds on the card and
    the same supersteps on the CPU, bit for bit."""
    es = _superstep_engine(dev, fused)
    er = _superstep_engine(dev, fused)
    ec = _superstep_engine("cpu", fused)
    for _ in range(2):
        es._stage(3)
        es._last_base = es._rounds_done
        torch.cuda.set_sync_debug_mode("error")
        try:
            spool = es._run_superstep(3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        es._rounds_done += 3
        sinks = es.spool_sinks(spool)
        rounds = [er.round() for _ in range(3)]
        cpu = ec.spool_sinks(ec.superstep(3))
        for a, b, c in zip(sinks, rounds, cpu):
            for x, y, z in zip(a, b, c):
                np.testing.assert_array_equal(_bits(x), _bits(y))
                np.testing.assert_array_equal(_bits(x), _bits(z))
    for f in es.state._fields:
        if f == "stats":
            for k in es.state.stats:
                _assert_bits(es.state.stats[k], er.state.stats[k])
                _assert_bits(es.state.stats[k], ec.state.stats[k])
        else:
            _assert_bits(getattr(es.state, f), getattr(er.state, f))
            _assert_bits(getattr(es.state, f), getattr(ec.state, f))


def test_iot_suite_on_the_card_equals_the_cpu(dev):
    """The ETL + STATS suite through supersteps, kernels on the card
    against the plain versions on the CPU: records, SLO report and window
    aggregates bit for bit."""
    from repro_torch.workloads import TraceConfig, build_suite, drive
    out = []
    for device in (dev, "cpu"):
        suite = build_suite(6, kinds=("etl", "stats"), window=16,
                            trace=TraceConfig(n_devices=6, rounds=10,
                                              seed=4),
                            cfg_overrides={"superstep": 3}, device=device)
        out.append(drive(suite, 3))
    a, b = out
    assert a["records"] == b["records"] > 0
    assert a["slo_report"] == b["slo_report"]
    for k in a["aggregates"]:
        np.testing.assert_array_equal(a["aggregates"][k].view(np.int32),
                                      b["aggregates"][k].view(np.int32))


# (S, W, D, E, C, mode): "third" routes the first third of each sender's
# items to destination 0 (it overflows) and the rest at random, some
# unrouted; "all" routes every item to the last destination; 32
# destinations, W = 1 and W > 4,096, slots no multiple of the 256-slot
# tile, C = 1 and 3 (the payload's 4-byte path)
@pytest.mark.parametrize("S,W,D,E,C,mode", [
    (1, 40, 1, 16, 3, "third"), (2, 300, 2, 64, 4, "third"),
    (3, 257, 3, 9, 1, "third"), (8, 129, 8, 2, 4, "third"),
    (2, 600, 32, 30, 4, "third"), (3, 500, 4, 300, 4, "all"),
    (2, 1, 3, 5, 4, "third"), (2, 5000, 4, 1000, 4, "third"),
    (1, 4500, 2, 4097, 3, "all"), (2, 700, 5, 513, 1, "third"),
    (2, 700, 5, 257, 3, "all")])
def test_exchange_compact_kernel_matches_plain(dev, S, W, D, E, C, mode):
    from repro_torch.kernels.round_fuse.kernel import exchange_compact_call
    from repro_torch.kernels.round_fuse.ops import exchange_compact
    rng = np.random.default_rng(S * W + E)
    vals = rng.standard_normal((S, W, C)).astype(np.float32)
    vals.ravel()[rng.integers(0, vals.size, 4)] = [np.nan, -0.0, np.inf,
                                                   1e-40]
    dest = rng.integers(0, D + 2, (S, W)).astype(np.int32)
    dest[:, : W // 3] = 0                      # one destination overflows
    if mode == "all":
        dest[:] = D - 1
    case = [rng.integers(-1, 900, (S, W)).astype(np.int32)
            for _ in range(4)] + [vals, dest]
    args = [torch.from_numpy(a).to(dev) for a in case]
    before = exchange_compact_call.launches
    got = exchange_compact_call(*args, D, E)
    assert exchange_compact_call.launches == before + 1
    _assert_bits(got, exchange_compact(*args, D, E, use_kernel=False))


def _programs(rng, shape, L, R, kind):
    """(*shape, L, 4) bytecode: "random" fusable opcodes with operands
    from -2 past R; "tail" the same with a non-NOP last instruction in
    every row; "nop" all NOPs; "diverse" row r runs opcode
    (r + 5 pc) mod 33 - 2 at pc, so 32 consecutive rows run 32 different
    opcodes at every pc (non-fusable, negative and too large ones run as
    NOP)."""
    pool = np.asarray(sorted(rf_ref.FUSABLE_OPS), np.int32)
    n = int(np.prod(shape))
    if kind == "diverse":
        ops = (np.arange(n)[:, None] + 5 * np.arange(L)[None, :]) % 33 - 2
    else:
        ops = rng.choice(pool, (n, L))
    if kind == "tail":
        ops[:, L - 1] = rng.choice(pool[pool != 0], n)
    if kind == "nop":
        ops[:] = 0
    operands = rng.integers(0 if kind == "random" else -2, R + 4, (n, L, 3))
    return np.concatenate([ops[..., None], operands], axis=-1).astype(
        np.int32).reshape(*shape, L, 4)


# (S, n_tab, n_snap, W, C, L, kind): the last non-NOP at L - 1, all-NOP
# programs, warps whose 32 lanes run 32 rows with 32 different opcodes at
# each pc, W no multiple of the CTA's items, C = 1 and 3, and (L None)
# the longest program whose CTA fits the shared-memory limit
@pytest.mark.parametrize("S,n_tab,n_snap,W,C,L,kind", [
    (1, 16, 16, 33, 3, 10, "random"), (4, 12, 48, 130, 3, 10, "random"),
    (2, 40, 64, 100, 3, 12, "tail"), (1, 20, 20, 45, 3, 12, "nop"),
    (2, 64, 100, 200, 3, 16, "diverse"), (3, 50, 70, 77, 1, 12, "tail"),
    (2, 30, 40, 65, 3, 9, "diverse"), (1, 8, 8, 40, 4, None, "tail")])
def test_apply_programs_kernel_matches_plain(dev, S, n_tab, n_snap, W, C, L,
                                             kind):
    from repro_torch.kernels.round_fuse import kernel as rk
    from repro_torch.kernels.round_fuse.kernel import apply_programs_call
    from repro_torch.kernels.round_fuse.ops import apply_programs
    rng = np.random.default_rng(S + W)
    layout = rf_ref.RegLayout.from_cfg(EngineConfig(
        n_streams=n_snap, channels=C, max_in=4, n_consts=6, n_temps=6))
    R = layout.n_regs
    if L is None:
        L = 1
        while rk.apply_smem_bytes(layout, L + 1, 6) <= rk.SMEM_LIMIT:
            L += 1
    values = rng.standard_normal((n_snap, C)).astype(np.float32)
    values.ravel()[rng.integers(0, values.size, 3)] = [np.nan, -0.0, 1e-40]
    rows = rng.integers(0, n_tab, (S, W)).astype(np.int32)
    if kind == "diverse":
        rows[:] = np.arange(W) % n_tab
    case = [rng.integers(-2, n_snap + 2, (S, n_tab, 4)).astype(np.int32),
            _programs(rng, (S, n_tab), L, R, kind),
            rng.standard_normal((S, n_tab, 6)).astype(np.float32),
            rng.random((S, n_tab)) < 0.7, rng.random((S, n_tab)) < 0.9,
            rows, rng.integers(0, n_snap, (S, W)).astype(np.int32),
            rng.integers(-2, n_snap + 2, (S, W)).astype(np.int32),
            rng.standard_normal((S, W, C)).astype(np.float32),
            rng.integers(-5, 30, (S, W)).astype(np.int32),
            rng.random((S, W)) < 0.8, values,
            rng.integers(-5, 30, n_snap).astype(np.int32)]
    args = [torch.from_numpy(a).to(dev) for a in case]
    before = apply_programs_call.launches
    got = apply_programs_call(layout, *args)
    assert apply_programs_call.launches == before + 1
    _assert_bits(got, apply_programs(layout, *args, use_kernel=False))


def test_apply_smem_bytes_matches_the_launcher(dev):
    """The wrapper's fit check reckons the shared bytes and the items per
    CTA that the launcher gives the kernel."""
    import ctypes
    from repro_torch.kernels.round_fuse import kernel as rk
    lib = rk._lib()
    assert lib.apply_programs_items() == rk.APPLY_ITEMS
    for cfg in (EngineConfig(), EngineConfig(channels=1, max_in=3,
                                             n_temps=5, n_consts=7)):
        layout = rf_ref.RegLayout.from_cfg(cfg)
        for L in (1, cfg.prog_len, 300):
            assert lib.apply_programs_smem(
                (ctypes.c_int * 10)(*layout), L, cfg.n_consts) == \
                rk.apply_smem_bytes(layout, L, cfg.n_consts)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_sharded_engine_on_the_card_equals_the_cpu(dev, fused):
    """A 2-shard engine with undersized exchange buckets, churned live,
    on the card (kernels) and on the CPU (plain versions): every round's
    sink and every state leaf bit for bit, and no table reallocated."""
    engines = []
    for device in (dev, "cpu"):
        cfg = EngineConfig(n_streams=24, n_tenants=4, batch=8, queue=64,
                           max_in=4, max_out=4, prog_len=24, n_temps=12,
                           n_shards=2, exchange_slots=3, dlq_slots=16,
                           fused_round=fused)
        reg = Registry.with_capacity(cfg)
        t = reg.create_tenant("t")
        srcs = [reg.create_stream(t, f"s{i}", ["v"]) for i in range(6)]
        comps = [reg.create_composite(t, f"c{i}", ["v"], srcs[i:i + 3],
                                      {"v": "in0.v + in1.v * 2 + in2.v"})
                 for i in range(4)]
        if not fused:
            reg.create_composite(t, "hot", ["v"], [srcs[0]],
                                 {"v": "tanh(in0.v)"})
        engines.append((create_engine(reg, device=device), t, srcs, comps))
    eg = engines[0][0]
    def ptrs():
        return [t.data_ptr() for t in (*eg.tables, eg._run_tables.progs)]
    before = ptrs()
    rng = np.random.default_rng(3)
    for r in range(8):
        if r == 3:
            for e, t, srcs, comps in engines:
                e.admit_composite(t, "late", ["v"], [srcs[1], comps[0]],
                                  {"v": "in0.v - in1.v"})
                e.swap_program(comps[2], {"v": "in0.v * 3"})
        if r == 6:
            for e, *_ in engines:
                e.revoke_stream(e.registry.streams[-1].sid)
        posts = [(int(i), float(rng.standard_normal()), r * 4 + int(i) % 3)
                 for i in rng.choice(6, 4, replace=False)]
        for e, t, srcs, comps in engines:
            for i, v, ts in posts:
                e.post(srcs[i], [v], ts)
        _assert_bits(tuple(eg.round()), tuple(engines[1][0].round()))
        ec = engines[1][0]
        for f in eg.state._fields:
            if f == "stats":
                for k in eg.state.stats:
                    _assert_bits(eg.state.stats[k], ec.state.stats[k])
            else:
                _assert_bits(getattr(eg.state, f), getattr(ec.state, f))
    assert ptrs() == before


@pytest.mark.parametrize("N,F,M", [(64, 4, 16), (300, 7, 33), (4096, 4, 4096),
                                   (4096, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_onehot_gather_kernel_matches_plain(dev, N, F, M, dtype):
    from repro_torch.kernels.stream_dispatch.kernel import onehot_gather_call
    from repro_torch.kernels.stream_dispatch.ops import onehot_gather
    rng = np.random.default_rng(N + F + M)
    if dtype == torch.int32:
        table = rng.integers(-2**31, 2**31 - 1, (N, F)).astype(np.int32)
    else:
        table = rng.standard_normal((N, F)).astype(np.float32)
        table.reshape(-1)[rng.integers(0, table.size, 7)] = np.array(
            [0x80000000, 0x00000001, 0x7fc12345, 0xffa00001, 0x7f800000,
             0xff800000, 0x807fffff], np.uint32).view(np.float32)
    ids = rng.integers(-2, N + 2, M).astype(np.int32)
    t, i = torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev)
    before = onehot_gather_call.launches
    got = onehot_gather_call(t, i)
    assert onehot_gather_call.launches == before + 1
    _assert_bits(got, onehot_gather(t, i, use_kernel=False))


@pytest.mark.parametrize("S,L,C,M", [(1, 64, 4, 100), (2, 300, 4, 700),
                                     (4, 1024, 4, 4096), (4, 97, 3, 200),
                                     (2, 50, 1, 64), (4, 33, 6, 150)])
def test_by_sid_snapshot_kernel_matches_plain(dev, S, L, C, M):
    """The sharded round's by-sid snapshot in one launch, bitwise against
    its plain version: ids from -2 to S L + 1 (zeros outside), -0.0,
    subnormals, NaN payloads and infinities among the values, INT32_MIN
    and INT32_MAX among the timestamps."""
    from repro_torch.kernels.stream_dispatch.kernel import \
        by_sid_snapshot_call
    from repro_torch.kernels.stream_dispatch.ops import by_sid_snapshot
    rng = np.random.default_rng(S * L + C)
    specials = np.array([0x80000000, 0x00000001, 0x807fffff, 0x7fc12345,
                         0xffa00001, 0x7f800000, 0xff800000],
                        np.uint32).view(np.float32)
    vals, ts = [], []
    for _ in range(S):
        v = rng.standard_normal((L, C)).astype(np.float32)
        v.reshape(-1)[rng.integers(0, L * C, len(specials))] = specials
        t = rng.integers(-2**31, 2**31 - 1, L).astype(np.int32)
        t[:2] = (-2**31, 2**31 - 1)
        vals.append(torch.from_numpy(v).to(dev))
        ts.append(torch.from_numpy(t).to(dev))
    ids = torch.from_numpy(
        rng.integers(-2, S * L + 2, M).astype(np.int32)).to(dev)
    before = by_sid_snapshot_call.launches
    got = by_sid_snapshot_call(vals, ts, ids)
    assert by_sid_snapshot_call.launches == before + 1
    _assert_bits(got, by_sid_snapshot(vals, ts, ids, use_kernel=False))


def test_by_sid_snapshot_reads_unaligned_planes(dev):
    """Shard planes that are views 4 bytes past a 16-byte boundary take
    4-byte words; more than 64 shards raise."""
    from repro_torch.kernels.stream_dispatch.kernel import \
        by_sid_snapshot_call
    from repro_torch.kernels.stream_dispatch.ops import by_sid_snapshot
    flat = torch.randn(129 * 4, device=dev)
    vals = [flat[1:513].view(128, 4), flat[:512].view(128, 4)]
    ts = [torch.arange(128, dtype=torch.int32, device=dev),
          torch.arange(128, dtype=torch.int32, device=dev) * -3]
    ids = torch.arange(-1, 257, dtype=torch.int32, device=dev)
    _assert_bits(by_sid_snapshot_call(vals, ts, ids),
                 by_sid_snapshot(vals, ts, ids, use_kernel=False))
    with pytest.raises(ValueError, match="64"):
        by_sid_snapshot_call(vals[:1] * 65, ts[:1] * 65, ids)


@pytest.mark.parametrize("n_tab,N,F,B", [(64, 64, 4, 16), (1024, 4096, 16, 64),
                                         (300, 97, 3, 20)])
@pytest.mark.parametrize("with_early", [True, False])
def test_stream_dispatch_kernel_matches_plain(dev, n_tab, N, F, B,
                                              with_early):
    from repro_torch.kernels.stream_dispatch.kernel import \
        stream_dispatch_call
    from repro_torch.kernels.stream_dispatch.ops import stream_dispatch
    rng = np.random.default_rng(n_tab + N + B)
    sid = rng.integers(-3, n_tab + 3, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    ts = rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)
    ts[:2] = (-2**31, 2**31 - 1)
    out_table = rng.integers(-5, N + 6, (n_tab, F)).astype(np.int32)
    tstab = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    args = [torch.from_numpy(a).to(dev)
            for a in (sid, ts, valid, out_table, tstab)]
    before = stream_dispatch_call.launches
    got = stream_dispatch_call(*args, with_early=with_early)
    assert stream_dispatch_call.launches == before + 1
    want = stream_dispatch(*args, with_early=with_early, use_kernel=False)
    _assert_bits(got[0], want[0])
    if with_early:
        _assert_bits(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("D,fused", [(1, False), (2, True)])
def test_dispatch_fanout_engine_on_the_card_equals_the_cpu(dev, D, fused):
    """An engine with ``fanout_fn=make_fanout()`` on the card (the
    dispatch kernel) and on the CPU (its plain version): every sink and
    state leaf bit for bit, one launch per round and shard."""
    from repro_torch.kernels.stream_dispatch.kernel import \
        stream_dispatch_call
    from repro_torch.kernels.stream_dispatch.ops import make_fanout
    engines = []
    for device in (dev, "cpu"):
        cfg = EngineConfig(n_streams=24, n_tenants=4, batch=8, queue=64,
                           max_in=4, max_out=4, prog_len=24, n_temps=12,
                           n_shards=D, fused_round=fused)
        reg = Registry.with_capacity(cfg)
        t = reg.create_tenant("t")
        srcs = [reg.create_stream(t, f"s{i}", ["v"]) for i in range(6)]
        for i in range(4):
            reg.create_composite(t, f"c{i}", ["v"], srcs[i:i + 3],
                                 {"v": "in0.v + in1.v * 2 + in2.v"})
        engines.append((create_engine(reg, device=device,
                                      fanout_fn=make_fanout()), srcs))
    (eg, srcs), (ec, _) = engines
    rng = np.random.default_rng(D)
    before = stream_dispatch_call.launches
    for r in range(6):
        for i in rng.choice(6, 4, replace=False):
            v, ts = float(rng.standard_normal()), r * 4 + int(i) % 3
            eg.post(srcs[i], [v], ts)
            ec.post(srcs[i], [v], ts)
        _assert_bits(tuple(eg.round()), tuple(ec.round()))
    assert stream_dispatch_call.launches == before + 6 * D
    for f in eg.state._fields:
        if f == "stats":
            for k in eg.state.stats:
                _assert_bits(eg.state.stats[k], ec.state.stats[k])
        else:
            _assert_bits(getattr(eg.state, f), getattr(ec.state, f))


# ------------------------------------------------------ model-plane kernels
def _fa_inputs(dev, seed, B, H, KV, L, Dh, dtype, transposed=False):
    """(B, L, H, Dh) q and (B, L, KV, Dh) k, v; ``transposed`` makes them
    transposed views of (B, H, L, Dh) and (B, KV, L, Dh) tensors."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, L, Dh), (B, KV, L, Dh)) if transposed else \
        ((B, L, H, Dh), (B, L, KV, Dh))
    q = rng.standard_normal(shapes[0]).astype(np.float32)
    k, v = (rng.standard_normal(shapes[1]).astype(np.float32) for _ in "kv")
    out = [torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)]
    return [t.transpose(1, 2) for t in out] if transposed else out


@pytest.mark.parametrize("B,H,KV,L,Dh,win", [
    (1, 2, 2, 128, 64, None), (2, 4, 2, 256, 128, None),
    (1, 4, 1, 256, 64, 64), (2, 2, 2, 128, 32, 32), (1, 8, 4, 128, 64, None),
    (2, 4, 1, 77, 256, 13), (1, 3, 1, 1, 16, None), (1, 4, 2, 200, 24, None),
    (1, 24, 2, 300, 128, None), (2, 12, 1, 129, 128, 64),
    (1, 32, 32, 200, 64, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, H, KV, L, Dh, win,
                                              dtype):
    """At the sweep of tests/test_kernels.py and odd shapes, the
    (B, H, L, Dh) tensors read through transposed views; among them
    mistral-large's GQA group of 12 at Dh 128 and musicgen's 32 heads of
    Dh 64."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
    q, k, v = _fa_inputs(dev, L + Dh, B, H, KV, L, Dh, dtype, True)
    got = flash_attention_blhd(q, k, v, window=win)
    torch.cuda.synchronize()
    want = flash_attention_blhd(q, k, v, window=win, use_kernel=False)
    assert got.dtype == dtype and got.shape == (B, L, H * Dh)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_the_model_layout(dev, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
    q, k, v = _fa_inputs(dev, 5, 2, 4, 1, 300, 256, dtype)
    got = flash_attention_blhd(q, k, v, window=64)
    want = flash_attention_blhd(q, k, v, window=64, use_kernel=False)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _assert_one_ulp(got, want):
    """bf16 ``got`` within one bf16 unit in the last place of the plain
    version (2^-7 |want| + 1e-5), chip_smoke.py's full-width gate."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    bad = (g - w).abs() > 2 ** -7 * w.abs() + 1e-5
    assert not bad.any(), (f"{int(bad.sum())} of {bad.numel()} elements "
                           f"past one bf16 unit; max |diff| "
                           f"{(g - w).abs().max().item()}")


# (B, H, KV, L, Dh, window): windows 63-65 and 127 on 64-key tiles (Dh 256)
# and on 128-key tiles (Dh 64, 128); lengths 1, 63-65 and 257 (one q block
# of 128 rows, its second warpgroup, three blocks); Dh 16, 24 (TMA's
# zero-filled columns), 20 and 77 (copied first); G = H / KV 1, 4 and 8
BAND_EDGES = [
    (1, 4, 1, 257, 256, 63), (1, 4, 1, 257, 256, 64),
    (1, 4, 1, 257, 256, 65), (1, 4, 1, 257, 256, 127),
    (1, 8, 1, 257, 128, 63), (1, 8, 1, 257, 128, 64),
    (1, 8, 1, 257, 128, 65), (1, 8, 2, 257, 64, 127),
    (2, 2, 2, 1, 16, None), (1, 4, 4, 63, 24, None), (1, 4, 1, 64, 16, 32),
    (2, 8, 1, 65, 24, None), (1, 2, 2, 257, 128, None),
    (1, 2, 1, 65, 20, None), (1, 4, 2, 100, 77, 50)]


@pytest.mark.parametrize("B,H,KV,L,Dh,win", BAND_EDGES)
def test_flash_attention_bf16_band_edges(dev, B, H, KV, L, Dh, win):
    """The bf16 (wgmma) kernel against its plain version at the edges of
    its tiles and of the causal/window band, within one bf16 unit."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
    q, k, v = _fa_inputs(dev, L * Dh + H, B, H, KV, L, Dh, torch.bfloat16)
    got = flash_attention_blhd(q, k, v, window=win)
    torch.cuda.synchronize()
    want = flash_attention_blhd(q, k, v, window=win, use_kernel=False)
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, H * Dh)
    _assert_one_ulp(got, want)


@pytest.mark.parametrize("B,H,KV,L,Dh,win", [
    (1, 4, 1, 1024, 256, 512), (1, 8, 2, 1024, 128, None),
    (2, 4, 2, 1024, 64, 300), (1, 24, 2, 1024, 128, None),
    (1, 32, 32, 1024, 64, None)])
def test_flash_attention_bf16_one_ulp_per_head_width(dev, B, H, KV, L, Dh,
                                                     win):
    """One mid-size shape per head-dim template (64, 128, 256), and the
    GQA group of 12 and 32 heads of Dh 64 of mistral-large and musicgen."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_blhd
    q, k, v = _fa_inputs(dev, Dh, B, H, KV, L, Dh, torch.bfloat16)
    got = flash_attention_blhd(q, k, v, window=win)
    torch.cuda.synchronize()
    _assert_one_ulp(got, flash_attention_blhd(q, k, v, window=win,
                                              use_kernel=False))


@pytest.mark.parametrize("Dh,win", [(256, None), (128, 65), (24, None)])
def test_flash_attention_bf16_launches_are_bitwise_equal(dev, Dh, win):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_call
    q, k, v = _fa_inputs(dev, 7, 2, 4, 1, 300, Dh, torch.bfloat16)
    first = flash_attention_call(q, k, v, window=win)
    second = flash_attention_call(q, k, v, window=win)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def _scan_args(dev, B, L, Di, S, offset=0):
    """a = exp(-|N|), bx, c, h0 ~ N from the seed L + Di; ``offset`` puts
    each tensor that many floats into its buffer."""
    rng = np.random.default_rng(L + Di)
    a = np.exp(-np.abs(rng.standard_normal((B, L, Di, S)))).astype(np.float32)
    bx = rng.standard_normal((B, L, Di, S)).astype(np.float32)
    c = rng.standard_normal((B, L, S)).astype(np.float32)
    h0 = rng.standard_normal((B, Di, S)).astype(np.float32)
    out = []
    for x in (a, bx, c, h0):
        buf = torch.empty(x.size + offset, device=dev)
        out.append(buf[offset:].view(x.shape).copy_(torch.from_numpy(x)))
    return out


# the sweep of tests/test_kernels.py and odd shapes; then both paths and
# both templates: L around one ring chunk and long, every S, B 4 with a
# carried state, Di 333 (no multiple of any CTA's channels), and 2 KB ring
# rows (Di 8,200 at B 2)
SCAN_CASES = [(1, 16, 32, 8), (2, 64, 128, 16), (1, 128, 256, 16),
              (2, 37, 40, 4), (1, 300, 96, 32)] + \
    [(4, L, 333, S) for L in (1, 2, RING_STEPS - 1, RING_STEPS,
                              RING_STEPS + 1, 300)
     for S in (1, 2, 4, 8, 16, 32)] + [(2, 33, 8200, 16)]


@pytest.mark.parametrize("B,L,Di,S", SCAN_CASES)
def test_selective_scan_kernel_matches_plain(dev, B, L, Di, S):
    from repro_torch.kernels.selective_scan.kernel import (
        plan_selective_scan, selective_scan_plan)
    from repro_torch.kernels.selective_scan.ops import selective_scan
    args = _scan_args(dev, B, L, Di, S)
    assert plan_selective_scan(*args)[0].plan == \
        selective_scan_plan(B, L, Di, S)
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    wy, wh = selective_scan(*args, use_kernel=False)
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, wh, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L,S", [(1, 16), (RING_STEPS + 1, 4), (300, 16)])
def test_selective_scan_kernel_reads_unaligned_views(dev, L, S):
    """Views one float into their buffers take the one-state template at
    any L (no 16-byte loads, no bulk copies)."""
    from repro_torch.kernels.selective_scan.kernel import plan_selective_scan
    from repro_torch.kernels.selective_scan.ops import selective_scan
    args = _scan_args(dev, 4, L, 333, S, offset=1)
    assert plan_selective_scan(*args)[0].plan.states == 1
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    wy, wh = selective_scan(*args, use_kernel=False)
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, wh, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [1, 300])
def test_selective_scan_launches_are_bitwise_equal(dev, L):
    from repro_torch.kernels.selective_scan.kernel import selective_scan_call
    args = _scan_args(dev, 4, L, 333, 16)
    y1, h1 = selective_scan_call(*args)
    y2, h2 = selective_scan_call(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
    assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def _flat(t):
    return [x for k in sorted(t) for x in _flat(t[k])] \
        if isinstance(t, dict) else [t]


def _smoke_batch(cfg, B, L, seed):
    """``batch_np``'s prompt batch as tensors on the CPU."""
    return {k: torch.from_numpy(v)
            for k, v in batch_np(cfg, B, L, seed).items()}


SMOKE_ARCHS = ["deepseek-moe-16b", "gemma3-1b", "gemma3-27b",
               "jamba-v0.1-52b", "minitron-8b", "mistral-large-123b",
               "musicgen-large", "qwen2-moe-a2.7b", "qwen2-vl-72b",
               "xlstm-1.3b"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_prefill_on_the_card_equals_the_cpu(dev, arch):
    """The SMOKE model's prefill through the kernels on the card against
    its plain versions on the CPU, from the same weights, in float32;
    one attention launch per attention layer."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_call)
    from repro_torch.models.config import ATTN, ATTN_LOCAL
    from repro_torch.models.model import make_prefill_step, param_specs
    from repro_torch.models.params import init_params
    cfg = get_smoke(arch)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    batch = _smoke_batch(cfg, 2, 64, 1)
    step = make_prefill_step(cfg)
    want = step(params, batch)
    flash_attention_call.launches = 0
    got = step(_tree(lambda t: t.to(dev), params),
               _tree(lambda t: t.to(dev), batch))
    torch.cuda.synchronize()
    assert flash_attention_call.launches == sum(
        m in (ATTN, ATTN_LOCAL) for m, _ in cfg.layer_specs)
    for g, w in zip(_flat({"l": got[0], "c": got[1]}),
                    _flat({"l": want[0], "c": want[1]})):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)


def _mlstm_inputs(dev, seed, B, H, L, Dh, gates="normal"):
    """q, k, v ~ N(0, 1); i ~ N(0, 1) and f ~ N(2, 1) as in
    tests/test_kernels.py, or gates pushed to an extreme."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32)
               for _ in "qkv")
    i = rng.standard_normal((B, H, L)).astype(np.float32)
    f = (rng.standard_normal((B, H, L)) + 2).astype(np.float32)
    if gates == "forget near 1":
        f += 6
    elif gates == "forget near 0":
        f -= 10
    elif gates == "very negative i":
        i -= 30
    return [torch.from_numpy(x).to(dev) for x in (q, k, v, i, f)]


@pytest.mark.parametrize("B,H,L,Dh,ck,gates", [
    (1, 2, 32, 16, 8, "normal"), (2, 2, 64, 32, 16, "normal"),
    (1, 4, 128, 64, 32, "normal"), (1, 1, 64, 128, 64, "normal"),
    (2, 3, 37, 16, 16, "normal"), (1, 2, 300, 128, 64, "normal"),
    (1, 1, 200, 1024, 256, "normal"), (1, 2, 96, 64, 32, "forget near 1"),
    (1, 2, 96, 64, 32, "forget near 0"), (1, 2, 96, 64, 32, "very negative i"),
    (1, 2, 640, 64, 256, "forget near 1")])
def test_mlstm_chunkwise_kernel_matches_plain(dev, B, H, L, Dh, ck, gates):
    """At the sweep of tests/test_kernels.py, lengths that are no multiple
    of the chunk (the kernel's last chunk is short, the plain version runs
    one chunk), Dh up to 1024 and extreme gates: h and the final (C, n,
    m) within 3e-4 of the plain chunkwise version and of the float64
    sequential oracle.  The last case has two full chunks of 256 rows
    after which the starting state still weighs (forget gates near 1), so
    q.n0 of rows 128-255 of a later chunk reaches h."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
    from repro_torch.kernels.mlstm_chunk.ref import (init_mlstm_state,
                                                     mlstm_ref)
    args = _mlstm_inputs(dev, L + Dh, B, H, L, Dh, gates)
    h, state = mlstm_chunkwise(*args, chunk=ck)
    torch.cuda.synchronize()
    wh, wstate = mlstm_chunkwise(*args, chunk=ck, use_kernel=False)
    rh, rstate = mlstm_ref(*args, *init_mlstm_state(B, H, Dh, device=dev))
    for want in ((wh, wstate), (rh, rstate)):
        for g, w in zip((h, *state), (want[0], *want[1])):
            assert g.dtype == torch.float32 and torch.isfinite(g).all()
            torch.testing.assert_close(g, w.float(), rtol=3e-4, atol=3e-4)


# (B, H, L, Dh, chunk): the last chunk short (37, 129, 257, 300 rows),
# chunks of 8-256 rows against the kernel's 128-row tiles, Dh 20 (no
# multiple of 8: copied into a padded buffer) up to 1,024
MLSTM_RAGGED = [(2, 3, 37, 16, 16), (1, 2, 129, 32, 64), (1, 1, 257, 64, 128),
                (1, 2, 300, 128, 256), (1, 1, 40, 20, 8), (1, 1, 333, 1024, 256)]


def _mlstm_close(got, want):
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w.float(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("B,H,L,Dh,ck", MLSTM_RAGGED)
@pytest.mark.parametrize("layout", ["contiguous", "heads outermost",
                                    "transposed"])
def test_mlstm_chunkwise_bf16_inputs_match_plain(dev, B, H, L, Dh, ck,
                                                 layout):
    """bf16 q, k, v (the bf16 prefill's) read as they are: contiguous,
    with the heads outermost (the layout the model's einsum leaves) or as
    transposed views (copied first), ragged chunks; within 3e-4 of the
    plain version (which upcasts them) and of the float64 oracle."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
    from repro_torch.kernels.mlstm_chunk.ref import (init_mlstm_state,
                                                     mlstm_ref)
    args = _mlstm_inputs(dev, L * 7 + Dh, B, H, L, Dh)
    qkv = [t.bfloat16() for t in args[:3]]
    if layout == "heads outermost":
        qkv = [t.transpose(0, 1).contiguous().transpose(0, 1) for t in qkv]
    elif layout == "transposed":
        qkv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in qkv]
    args[:3] = qkv
    got = mlstm_chunkwise(*args, chunk=ck)
    torch.cuda.synchronize()
    _mlstm_close(got, mlstm_chunkwise(*args, chunk=ck, use_kernel=False))
    _mlstm_close(got, mlstm_ref(*args, *init_mlstm_state(B, H, Dh,
                                                          device=dev)))


@pytest.mark.parametrize("B,H,L,Dh,ck", MLSTM_RAGGED)
def test_mlstm_chunkwise_float32_ragged_chunks(dev, B, H, L, Dh, ck):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
    args = _mlstm_inputs(dev, L * 5 + Dh, B, H, L, Dh)
    got = mlstm_chunkwise(*args, chunk=ck)
    torch.cuda.synchronize()
    _mlstm_close(got, mlstm_chunkwise(*args, chunk=ck, use_kernel=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_chunkwise_launches_are_bitwise_equal(dev, dtype):
    """The state pass walks its chunks in order and nothing uses atomics:
    two calls give the same bits.  Chunks of 256 rows (two row blocks,
    three CTAs of the intra pass each) over L 640, forget gates near 1."""
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunkwise_call
    args = _mlstm_inputs(dev, 11, 2, 2, 640, 256, "forget near 1")
    args[:3] = [t.to(dtype) for t in args[:3]]
    first = mlstm_chunkwise_call(*args, chunk=256)
    second = mlstm_chunkwise_call(*args, chunk=256)
    torch.cuda.synchronize()
    for a, b in zip((first[0], *first[1]), (second[0], *second[1])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mlstm_chunkwise_kernel_refuses_a_carried_state(dev):
    """The kernel serves prefill from the zero state; a carried state on
    the card raises instead of taking the plain path."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise
    from repro_torch.kernels.mlstm_chunk.ref import init_mlstm_state
    args = _mlstm_inputs(dev, 0, 1, 2, 32, 16)
    state = init_mlstm_state(1, 2, 16, device=dev)
    with pytest.raises(ValueError, match="zero state"):
        mlstm_chunkwise(*args, state, chunk=8)
    h, _ = mlstm_chunkwise(*args, state, chunk=8, use_kernel=False)
    assert h.shape == (1, 2, 32, 16)


def test_xlstm_smoke_prefill_launches_the_kernel_per_mlstm_layer(dev):
    """One SMOKE prefill (one period: an sLSTM and 7 mLSTM layers) makes
    the kernel's LAUNCHES_PER_CALL launches once per mLSTM layer."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.mlstm_chunk.kernel import (LAUNCHES_PER_CALL,
                                                        mlstm_chunkwise_call)
    from repro_torch.models.config import MLSTM
    from repro_torch.models.model import make_prefill_step, param_specs
    from repro_torch.models.params import init_params
    cfg = get_smoke("xlstm-1.3b")
    params = init_params(param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40))).to(dev)
    mlstm_chunkwise_call.launches = 0
    logits, _ = make_prefill_step(cfg)(params, {"tokens": tok})
    torch.cuda.synchronize()
    n_mlstm = sum(m == MLSTM for m, _ in cfg.layer_specs)
    assert n_mlstm == 7
    assert mlstm_chunkwise_call.launches == LAUNCHES_PER_CALL * n_mlstm
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------ fault tooling
def test_supervised_drill_on_the_card_equals_the_cpu(dev, tmp_path):
    """A short supervised drill on the card at 1 shard (the fused round's
    kernel): poison payloads, a hostile overflow swap, a torn newest
    checkpoint with a ``ShardKill``.  The restore stays on the card, the
    kernel launches once per round of every superstep run (replay
    included), and the recovered engine equals an undisturbed twin that
    took the same feed on the CPU, every snapshot array bitwise."""
    from repro_torch.launch import (ShardKill, Supervisor,
                                    corrupt_checkpoint,
                                    inject_hostile_program,
                                    inject_payload_corruption)
    K, n_steps, kill_at = 2, 8, 5

    def engine(device):
        cfg = EngineConfig(n_streams=24, n_tenants=4, batch=8, queue=64,
                           max_in=4, max_out=4, prog_len=24, n_temps=12,
                           superstep=K, checkpoint_every=2,
                           retention_slots=4, dlq_slots=16,
                           fault_window=8, fault_threshold=2)
        reg = Registry.with_capacity(cfg)
        t, u = reg.create_tenant("t"), reg.create_tenant("u")
        a, b = (reg.create_stream(t, n, ["v"]) for n in "ab")
        reg.create_composite(t, "ab", ["v"], [a, b], {"v": "a.v * 2.0 + b.v"})
        q = reg.create_stream(u, "q", ["v"])
        reg.create_composite(u, "q1", ["v"], [q], {"v": "q.v + 1.0"})
        return create_engine(reg, device=device)

    def feed(e, step):
        rng = np.random.default_rng([7, step])
        by = {s.name: s for s in e.registry.streams if s is not None}
        e.post(by["q"].sid, [float(step)], ts=10 * step)
        for dt in (0, 1):
            if step in (1, 4):
                inject_payload_corruption(e, by["a"].sid, 10 * step + dt, rng)
            else:
                e.post(by["a"].sid, [0.5 * step + dt], ts=10 * step + dt)
        e.post(by["b"].sid, [-1.0 * step], ts=10 * step)
        if step == 3:
            inject_hostile_program(e, by["ab"], [by["a"], by["b"]], rng)

    def chaos(e, step):
        if step == kill_at:
            e._ckpt.wait()
            assert corrupt_checkpoint(str(tmp_path), np.random.default_rng(0),
                                      mode="truncate") is not None
            raise ShardKill("drill kill")

    eng = engine(dev)
    before = fused_round_call.launches
    sup = Supervisor(eng, str(tmp_path), feed=feed, chaos=chaos, K=K)
    report = sup.run(n_steps)
    torch.cuda.synchronize()
    inc, = report.incidents
    assert report.recovered and inc.restored_step == 2
    got = report.engine
    assert got is not eng and got.device == dev and got._path == "fused"
    n_super = n_steps - 1 + inc.replayed_steps
    assert fused_round_call.launches == before + n_super * K
    twin = engine("cpu")
    for step in range(n_steps):
        feed(twin, step)
        twin.superstep(K)
    got.checkpoint_to(None)
    (xa, ma), (xb, mb) = got.snapshot(), twin.snapshot()
    assert sorted(xa) == sorted(xb) and ma == mb
    for k in xa:
        np.testing.assert_array_equal(_bits(xa[k]), _bits(xb[k]), err_msg=k)
    assert got.fault_counters()["quarantined"].any()


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_decode_on_the_card_equals_the_cpu(dev, arch):
    """The SMOKE model's decode step (float32) on the card against the
    CPU from the same prefill caches: logits and every returned cache
    leaf; a Mamba layer launches the selective-scan kernel once a step."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.selective_scan.kernel import selective_scan_call
    from repro_torch.models.config import MAMBA
    from repro_torch.models.model import (make_decode_step,
                                          make_prefill_step, param_specs)
    from repro_torch.models.params import init_params
    cfg = get_smoke(arch)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    batch = _smoke_batch(cfg, 2, 40, 1)
    _, caches = make_prefill_step(cfg, pad_to=48)(
        params, _tree(lambda t: t[:, :-1], batch))
    pos = torch.full((2,), 39, dtype=torch.int32)
    step = make_decode_step(cfg)
    last = _tree(lambda t: t[:, -1:].contiguous(), batch)
    want = step(params, caches, last, pos)
    selective_scan_call.launches = 0
    got = step(_tree(lambda t: t.to(dev), params),
               _tree(lambda t: t.to(dev), caches),
               _tree(lambda t: t.to(dev), last), pos.to(dev))
    torch.cuda.synchronize()
    assert selective_scan_call.launches == sum(
        m == MAMBA for m, _ in cfg.layer_specs)
    for g, w in zip(_flat({"l": got[0], "c": got[1]}),
                    _flat({"l": want[0], "c": want[1]})):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)


def _record_gaps(b):
    """Wrap batcher ``b``'s step to record the top-2 logit gap of every
    slot that emits a token at the tick."""
    gaps, inner = [], b._step

    def step():
        lg = inner()
        for s, req in enumerate(b.live):
            if req is not None and not b._pending_prompt.get(s):
                top = np.sort(lg[s])[-2:]
                gaps.append(float(top[1] - top[0]))
        return lg
    b._step = step
    return gaps


def _serve_smoke(device, n_req=5):
    """gemma3-1b SMOKE (float32) on 2 slots: {rid: tokens} and the
    smallest top-2 logit gap of every emitted token."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_params
    from repro_torch.serving import ContinuousBatcher, Request
    cfg = get_smoke("gemma3-1b")
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(2),
                         "cpu")
    b = ContinuousBatcher(cfg, params, slots=2, max_len=64, device=device)
    gaps = _record_gaps(b)
    for i in range(n_req):
        b.submit(Request(rid=i, prompt=[3 + i, 40 + i], max_tokens=3 + i))
    return {r.rid: r.output for r in b.run_until_drained()}, min(gaps), b


def test_batcher_on_the_card_equals_the_cpu(dev):
    """The batcher's tokens on the card (its tick's tokens and positions
    in one pinned copy, the logits in one readback) equal the CPU's on a
    well-posed run (greedy tokens are exact only without ties)."""
    want, gap, _ = _serve_smoke("cpu")
    assert gap > 1e-4, f"top-2 gap {gap}"
    got, _, b = _serve_smoke(dev)
    assert got == want and sorted(got) == list(range(5))
    assert b.caches["scan"]["s0"]["k"].device == dev


def test_pred_suite_on_the_card_equals_the_cpu(dev):
    """A small IoT suite with PRED flows served by a gemma3-1b SMOKE
    batcher: the engine and the batcher on the card equal both on the CPU
    (records, SLO report and histograms, completions, engine counters)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_params
    from repro_torch.serving import ContinuousBatcher
    from repro_torch.workloads import TraceConfig, build_suite, drive
    from repro_torch.workloads import wire_pred
    cfg = get_smoke("gemma3-1b")
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(4),
                         "cpu")
    runs = []
    for device in ("cpu", dev):
        suite = build_suite(6, trace=TraceConfig(n_devices=6, rounds=6,
                                                 seed=4),
                            cfg_overrides={"superstep": 3}, device=device)
        b = ContinuousBatcher(cfg, params, slots=2, max_len=64,
                              device=device)
        gaps = _record_gaps(b)
        wire_pred(suite, b)
        out = drive(suite, 3)
        assert min(gaps) > 1e-4, f"top-2 gap {min(gaps)}"
        runs.append((out["records"], out["slo_report"],
                     suite.slo.hist.tolist(),
                     [(r.rid, r.output) for r in suite.bridge.completed],
                     suite.engine.counters()))
    assert runs[1] == runs[0] and runs[0][3]
