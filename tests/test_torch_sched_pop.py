"""The port's scheduler pop against the JAX package's: ``sched_pop_ref``
and the lexsort ``_pop`` of the port return the same slots and payload
bits as ``repro``'s ``sched_pop`` — its jnp ref and its Pallas kernel in
interpret mode — on INT_MAX and negative priorities, seq collisions,
zero/one/FAIR_SCALE weights and the RANK_LIM boundary."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the CPU ops here are tiny: one thread, so that parallel test workers
# do not contend for the cores through torch's thread pools
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.kernels.sched_pop.ops import sched_pop as j_sched_pop  # noqa: E402
from repro_torch.core import EngineConfig as PConfig  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.kernels.sched_pop.ops import sched_pop  # noqa: E402
from repro_torch.kernels.sched_pop.ref import RANK_LIM  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _planes(seed, Q, T, C):
    rng = np.random.default_rng(seed)
    prio = rng.choice([0, 1, 5, 2**31 - 1, -2], Q).astype(np.int32)
    seq = rng.integers(-3, 40, Q).astype(np.int32)          # collisions
    valid = rng.random(Q) < 0.6
    tenant = rng.integers(0, T, Q).astype(np.int32)
    w = rng.choice([0, 1, 4, 2**15], T).astype(np.int32)[tenant]
    sid = rng.integers(0, 64, Q).astype(np.int32)
    ts = rng.integers(-2**31 + 1, 2**31 - 1, Q).astype(np.int32)
    vals = rng.standard_normal((Q, C)).astype(np.float32)
    vals[rng.random((Q, C)) < 0.2] = -0.0
    vals[rng.random((Q, C)) < 0.05] = np.nan
    return prio, seq, valid, tenant, w, sid, vals, ts


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("Q,T,B,C", [(5, 2, 3, 1), (130, 3, 16, 4),
                                     (256, 1, 8, 2), (64, 4, 64, 3)])
@pytest.mark.parametrize("jax_path", ["ref", "pallas_interpret"])
def test_ref_matches_jax_sched_pop(Q, T, B, C, jax_path):
    planes = _planes(Q * 7 + B, Q, T, C)
    j = [jnp.asarray(a) for a in planes]
    kw = (dict(use_kernel=False) if jax_path == "ref"
          else dict(use_kernel=True, interpret=True))
    take_j, pop_j = j_sched_pop(*j, B, **kw)
    p = [torch.from_numpy(a) for a in planes]
    take_p, pop_p = sched_pop(*p, B)
    np.testing.assert_array_equal(np.asarray(take_j), take_p.numpy())
    for a, b, name in zip(pop_j, pop_p, ("sid", "vals", "ts", "valid")):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=name)


def _states(seed, Q, N, T):
    rng = np.random.default_rng(seed)
    q_sid = rng.integers(0, N, Q).astype(np.int32)
    q_seq = rng.integers(0, 12, Q).astype(np.int32)          # collisions
    q_valid = rng.random(Q) < 0.7
    q_ts = rng.integers(-100, 100, Q).astype(np.int32)
    q_vals = rng.standard_normal((Q, 2)).astype(np.float32)
    q_its = rng.integers(0, 9, Q).astype(np.int32)
    prio = rng.choice([0, 1, -3, 2**31 - 1], N).astype(np.int32)
    tenant = rng.integers(-1, T + 1, N).astype(np.int32)     # clipped
    weight = rng.choice([0, 1, 3, 2**15], T).astype(np.int32)
    return (q_sid, q_seq, q_valid, q_ts, q_vals, q_its), prio, tenant, weight


def _jax_state(cfg, q):
    s = JE.init_state(cfg)
    return s._replace(**{f: jnp.asarray(a) for f, a in zip(
        ("q_sid", "q_seq", "q_valid", "q_ts", "q_vals", "q_its"), q)})


def _port_state(cfg, q):
    s = PE.init_state(cfg, "cpu")
    return s._replace(**{f: torch.from_numpy(a) for f, a in zip(
        ("q_sid", "q_seq", "q_valid", "q_ts", "q_vals", "q_its"), q)})


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scheduler", ["packed", "lexsort"])
@pytest.mark.parametrize("qos", [True, False])
def test_port_pop_matches_jax_pop(seed, scheduler, qos):
    Q, N, T, B = 48, 20, 3, 12
    q, prio, tenant, weight = _states(seed, Q, N, T)
    jc = JConfig(n_streams=N, n_tenants=T, queue=Q, batch=B, channels=2)
    pc = PConfig(n_streams=N, n_tenants=T, queue=Q, batch=B, channels=2)
    jargs = (jnp.asarray(tenant), jnp.asarray(weight)) if qos else (None, None)
    pargs = ((torch.from_numpy(tenant), torch.from_numpy(weight)) if qos
             else (None, None))
    sj, pj = JE._pop(_jax_state(jc, q), jnp.asarray(prio), B, *jargs,
                     "lexsort")
    sp, pp = PE._pop(_port_state(pc, q), torch.from_numpy(prio), B, *pargs,
                     scheduler)
    for a, b, name in zip(pj, pp, ("sid", "vals", "ts", "its", "valid")):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(sj.q_valid), sp.q_valid.numpy())


def test_rank_clamp_boundary():
    """Past RANK_LIM queued SUs of one weight-1 tenant the virtual tag
    would wrap int32; both port pops clamp like the JAX package and keep
    FIFO order at the boundary."""
    Q, B = RANK_LIM + 66, 8
    jc = JConfig(n_streams=2, n_tenants=2, channels=1, queue=Q, batch=B)
    pc = PConfig(n_streams=2, n_tenants=2, channels=1, queue=Q, batch=B)
    js, _ = JE._enqueue(JE.init_state(jc), jnp.zeros((Q,), jnp.int32),
                        jnp.zeros((Q, 1), jnp.float32),
                        jnp.arange(Q, dtype=jnp.int32), jnp.ones((Q,), bool))
    ps, dropped = PE._enqueue(PE.init_state(pc, "cpu"),
                              torch.zeros((Q,), dtype=torch.int32),
                              torch.zeros((Q, 1)),
                              torch.arange(Q, dtype=torch.int32),
                              torch.ones((Q,), dtype=torch.bool))
    assert int(dropped) == 0
    np.testing.assert_array_equal(np.asarray(js.q_seq), ps.q_seq.numpy())
    zero2 = np.zeros(2, np.int32)
    w = np.array([1, 0], np.int32)
    _, pj = JE._pop(js, jnp.asarray(zero2), B, jnp.asarray(zero2),
                    jnp.asarray(w), "lexsort")
    for scheduler in ("packed", "lexsort"):
        _, pp = PE._pop(ps, torch.from_numpy(zero2), B,
                        torch.from_numpy(zero2), torch.from_numpy(w),
                        scheduler)
        for a, b in zip(pj, pp):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        assert pp[2].tolist() == list(range(B))


def test_wrapper_on_cpu_takes_the_plain_version_only():
    """On CPU tensors the wrapper runs the plain version; asking for the
    CUDA kernel there raises instead of falling back."""
    planes = [torch.from_numpy(a) for a in _planes(1, 16, 2, 1)]
    with pytest.raises(ValueError):
        sched_pop(*planes, 4, use_kernel=True)
    take, _ = sched_pop(*planes, 4, use_kernel=False)
    assert take.dtype == torch.int32 and take.shape == (4,)


def _edge(name):
    """Queue planes for one of the cases the sorted-selection kernel
    meets: ``(Q, T, B, prio, seq, valid, tenant, weight)``, the weight per
    tenant (``w_slot = weight[tenant]``, as the engine builds it)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    Q, T, B = {"batch_is_queue": (200, 5, 200), "all_invalid": (300, 4, 64),
               "queue_2047": (2047, 16, 64), "queue_2049": (2049, 16, 64),
               "one_tenant": (500, 1, 64), "tenants_1024": (2048, 1024, 64),
               "int_max_beside_invalid": (256, 6, 64),
               "negative_ties": (256, 8, 64)}[name]
    prio = rng.choice([0, 0, 1, 3, -2, 2**31 - 1], Q).astype(np.int32)
    seq = rng.integers(-5, Q // 4, Q).astype(np.int32)
    valid = rng.random(Q) < 0.7
    if name == "all_invalid":
        valid[:] = False
    if name == "int_max_beside_invalid":
        # valid slots at the largest priority share key INT_MAX and seqs
        # with invalid ones: they order by tag, then seq, then slot
        prio = np.where(rng.random(Q) < 0.8, 2**31 - 1, 1).astype(np.int32)
        seq = rng.integers(0, 3, Q).astype(np.int32)
    if name == "negative_ties":
        prio = rng.choice([-5, -2], Q).astype(np.int32)
        seq = rng.integers(-3, -1, Q).astype(np.int32)
    tenant = rng.integers(0, T, Q).astype(np.int32)
    weight = rng.choice([0, 1, 2, 7, 2**15], T).astype(np.int32)
    if name == "one_tenant":
        weight[:] = 1
    return Q, T, B, prio, seq, valid, tenant, weight


@pytest.mark.parametrize("jax_path", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("name", ["batch_is_queue", "all_invalid",
                                  "queue_2047", "queue_2049", "one_tenant",
                                  "tenants_1024", "int_max_beside_invalid",
                                  "negative_ties"])
def test_pop_edges_match_jax(name, jax_path):
    """The port's plain pop, its lexsort ``_pop`` and ``repro``'s pop (its
    ref and its Pallas kernel in interpret mode) pick the same slots and
    payload bits on the edges of the sorted selection: B == Q, no valid
    slot, queues that are no power of two, one tenant and 1,024 tenants,
    valid INT_MAX priorities beside invalid slots of equal seq, negative
    priorities and seqs tied across tenants."""
    Q, T, B, prio, seq, valid, tenant, weight = _edge(name)
    rng = np.random.default_rng(Q + B)
    sid = np.arange(Q, dtype=np.int32)
    ts = rng.integers(-9, 9, Q).astype(np.int32)
    vals = rng.standard_normal((Q, 2)).astype(np.float32)
    vals[rng.random((Q, 2)) < 0.1] = -0.0
    planes = (prio, seq, valid, tenant, weight[tenant], sid, vals, ts)
    kw = (dict(use_kernel=False) if jax_path == "ref"
          else dict(use_kernel=True, interpret=True))
    take_j, pop_j = j_sched_pop(*[jnp.asarray(a) for a in planes], B, **kw)
    take_p, pop_p = sched_pop(*[torch.from_numpy(a) for a in planes], B)
    np.testing.assert_array_equal(np.asarray(take_j), take_p.numpy())
    for a, b, what in zip(pop_j, pop_p, ("sid", "vals", "ts", "valid")):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=what)
    # the lexsort oracle on the same queue (slot s holds sid s)
    pc = PConfig(n_streams=Q, n_tenants=T, queue=Q, batch=B, channels=2)
    q = (sid, seq, valid, ts, vals, np.zeros(Q, np.int32))
    _, lex = PE._pop(_port_state(pc, q), torch.from_numpy(prio), B,
                     torch.from_numpy(tenant), torch.from_numpy(weight),
                     "lexsort")
    np.testing.assert_array_equal(lex[0].numpy(), take_p.numpy())
    for a, b in zip(lex[1:3] + lex[4:], pop_p[1:]):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


@pytest.mark.parametrize("batch,largest", [(64, 11050), (1, 11062),
                                           (None, 9292)])
def test_smem_bytes_admits_the_stated_limit(batch, largest):
    """The kernel's shared-memory layout (21 bytes a slot, 4 a pick, 128
    for the rank scan) admits the largest queue its docstring states and
    refuses the next (``batch=None``: a pop of the whole queue)."""
    from repro_torch.kernels.sched_pop.kernel import (SMEM_LIMIT, check_fits,
                                                      smem_bytes)
    for Q, ok in ((largest, True), (largest + 1, False)):
        B = Q if batch is None else batch
        assert (smem_bytes(Q, B) <= SMEM_LIMIT) == ok
        if ok:
            check_fits(Q, B)
        else:
            with pytest.raises(ValueError):
                check_fits(Q, B)
