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

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(x):
    a = x.cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got, want):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _assert_bits(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _queue(rng, Q, C, T, N):
    vals = rng.standard_normal((Q, C)).astype(np.float32)
    vals.ravel()[rng.integers(0, Q * C, 3)] = [np.nan, -0.0, np.inf]
    tenant = rng.integers(0, T, Q).astype(np.int32)
    return [rng.choice([0, 1, -2, 2**31 - 1], Q).astype(np.int32),
            rng.integers(-3, 20, Q).astype(np.int32), rng.random(Q) < 0.7,
            tenant,
            rng.choice([0, 1, 5, 1 << 15], T).astype(np.int32)[tenant],
            rng.integers(0, N + 3, Q).astype(np.int32), vals,
            rng.integers(-9, 9, Q).astype(np.int32)]


@pytest.mark.parametrize("Q,B,C", [(5, 3, 1), (100, 16, 3), (2048, 64, 4)])
def test_sched_pop_kernel_matches_plain(dev, Q, B, C):
    rng = np.random.default_rng(Q)
    prio, seq, valid, tenant, w, sid, vals, ts = (
        torch.from_numpy(a).to(dev) for a in _queue(rng, Q, C, 3, 64))
    got = sched_pop_call(prio, seq, valid, tenant, w, sid, vals, ts, B)
    want = sched_pop(prio, seq, valid, tenant, w, sid, vals, ts, B,
                     use_kernel=False)
    _assert_bits(got, want)


@pytest.mark.parametrize("Q,N,C,B,F,M,L", [(32, 16, 1, 2, 2, 2, 4),
                                           (200, 40, 4, 8, 3, 4, 12),
                                           (300, 200, 3, 16, 9, 5, 20)])
def test_fused_round_kernel_matches_plain(dev, Q, N, C, B, F, M, L):
    rng = np.random.default_rng(Q + N)
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
                       axis=-1).astype(np.int32),
              rng.standard_normal((N, 6)).astype(np.float32),
              rng.random(N) < 0.7, rng.random(N) < 0.85, values,
              rng.integers(-5, 30, N).astype(np.int32)]
    q = [torch.from_numpy(a).to(dev) for a in _queue(rng, Q, C, 4, N)]
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
