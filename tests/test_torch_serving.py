"""The port's serving plane against the JAX package's, on the CPU.

``ContinuousBatcher``: on gemma3-1b SMOKE (vocab 128, float32) five
requests on two slots and then one more give ``repro``'s tokens, which
are also the port's sequential greedy decode through ``forward``
(``tests/test_training_serving.py:92``, ``:103``); on xlstm-1.3b SMOKE a
request that takes a freed slot continues that slot's recurrent state in
both packages alike (``repro`` resets only the position); on the other
five text architectures' SMOKE configs four requests on two slots give
``repro``'s tokens, and both packages refuse musicgen-large and
qwen2-vl-72b in the batcher and the launcher.  Greedy tokens
are exact only where the logits do not tie, so each run first asserts
the reference's smallest top-2 gap (the run is well posed).  The
throttle hook's pass-over (``tests/test_qos.py:391``).

``ModelBackedStreams``: the engine -> model -> engine round trip with a
real batcher (``test_training_serving.py:118``), and with stub batchers
the counterparts of ``test_qos.py:355``, ``test_admission.py:457``,
``test_durability.py:418``, ``test_elastic.py:392``,
``test_fault_plane.py:584`` and ``test_superstep.py:282`` (1 shard) and
``:321`` (2 shards): each scenario runs through both packages and its
observations must be equal."""
import dataclasses
import json
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.core as JCore  # noqa: E402
import repro_torch.core as PCore  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import batcher as JB  # noqa: E402
from repro.serving.bridge import ModelBackedStreams as JBridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.convert import (caches_to_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serving import batcher as PB  # noqa: E402
from repro_torch.serving.bridge import ModelBackedStreams as PBridge  # noqa: E402

GAP = 1e-4          # least top-2 logit gap of a well-posed greedy run

J = SimpleNamespace(name="repro", EngineConfig=JCore.EngineConfig,
                    Registry=JCore.Registry, Bridge=JBridge, B=JB,
                    create_engine=lambda reg: JCore.create_engine(reg),
                    restore_engine=lambda snap: JCore.restore_engine(snap))
T = SimpleNamespace(name="repro_torch", EngineConfig=PCore.EngineConfig,
                    Registry=PCore.Registry, Bridge=PBridge, B=PB,
                    create_engine=lambda reg: PCore.create_engine(
                        reg, device="cpu"),
                    restore_engine=lambda snap: PCore.restore_engine(
                        snap, device="cpu"))


def _cfg(pkg, **kw):
    base = dict(n_streams=16, n_tenants=4, batch=8, queue=64, max_in=4,
                max_out=4, prog_len=24, n_temps=12, retention_slots=6,
                dlq_slots=16)
    base.update(kw)
    return pkg.EngineConfig(**base)


def _stub(submitted=None, throttle=False):
    """The batcher surface the bridge's control plane touches."""
    sub = [] if submitted is None else submitted
    b = SimpleNamespace(cfg=SimpleNamespace(vocab=64), submit=sub.append,
                        run_ticks=lambda n: [], queue=[], live=[])
    if throttle:
        b.throttle = None
    return b, sub


# --------------------------------------------------------------------------
# the batcher
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """SMOKE weights of gemma3-1b (vocab 128) and xlstm-1.3b, drawn by
    ``repro``, in both packages, with one jitted decode per arch shared by
    every ``repro`` batcher (a batcher builds its own jit otherwise)."""
    out = {}
    for arch, over in (("gemma3-1b", {"vocab": 128}), ("xlstm-1.3b", {})):
        jcfg = dataclasses.replace(JC.get_smoke(arch), **over)
        pcfg = dataclasses.replace(PC.get_smoke(arch), **over)
        jp = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(7))
        out[arch] = (jcfg, pcfg, jp,
                     params_from_numpy(jax.tree.map(np.asarray, jp)),
                     jax.jit(JM.make_decode_step(jcfg)))
    return out


def _batchers(models, arch, slots=2, max_len=64):
    jcfg, pcfg, jp, pp, jdecode = models[arch]
    jb = JB.ContinuousBatcher(jcfg, jp, slots=slots, max_len=max_len)
    jb._decode = jdecode
    return jb, PB.ContinuousBatcher(pcfg, pp, slots=slots, max_len=max_len,
                                    device="cpu")


def _record_gaps(b):
    """Wrap ``b``'s decode to record the top-2 gap of every slot that
    emits a token at that tick (live, prompt consumed)."""
    gaps, inner = [], b._decode

    def decode(params, caches, batch, pos):
        logits, caches = inner(params, caches, batch, pos)
        lg = np.asarray(logits[:, 0], np.float32)
        pending = getattr(b, "_pending_prompt", {})
        for s, req in enumerate(b.live):
            if req is not None and not pending.get(s):
                top = np.sort(lg[s])[-2:]
                gaps.append(float(top[1] - top[0]))
        return logits, caches
    b._decode = decode
    return gaps


def _serve(b, pkg, reqs):
    for rid, prompt, n in reqs:
        b.submit(pkg.B.Request(rid=rid, prompt=list(prompt), max_tokens=n))
    done = b.run_until_drained()
    return {r.rid: r.output for r in done}


def _sequential_greedy(cfg, params, prompt, n):
    """Plain full-forward greedy decoding in the port."""
    toks = list(prompt)
    for _ in range(n):
        lg, _, _ = PM.forward(cfg, params, tokens=torch.tensor([toks]))
        toks.append(int(np.argmax(lg[0, -1].float().numpy())))
    return toks[len(prompt):]


def test_batcher_matches_repro_and_sequential_decode(models):
    jb, pb = _batchers(models, "gemma3-1b")
    gaps = _record_gaps(jb)
    waves = [[(i, (3 + i, 40 + i), 3 + i) for i in range(5)],   # :103
             [(5, (5, 9, 17), 6)]]                              # :92
    for reqs in waves:
        want = _serve(jb, J, reqs)
        assert min(gaps) > GAP, f"reference top-2 gap {min(gaps)}"
        got = _serve(pb, T, reqs)
        assert got == want
        assert sorted(got) == [r[0] for r in reqs]
        pcfg, pp = models["gemma3-1b"][1], models["gemma3-1b"][3]
        for rid, prompt, n in reqs:
            assert len(got[rid]) == n
            assert got[rid] == _sequential_greedy(pcfg, pp, prompt, n), rid
    assert pb.ticks == jb.ticks


def test_slot_reuse_carries_recurrent_state(models):
    """Three requests on two slots of xlstm-1.3b: the third takes a
    freed slot whose mLSTM and sLSTM states are not reset.  Both
    packages carry alike: equal tokens, equal caches."""
    jb, pb = _batchers(models, "xlstm-1.3b")
    gaps = _record_gaps(jb)
    reqs = [(0, (5, 9), 2), (1, (7, 3, 2, 8), 5), (2, (11, 4), 4)]
    carried = []
    for b in (jb, pb):
        admit = b._admit

        def spy(b=b, admit=admit):
            free = [s for s, r in enumerate(b.live) if r is None]
            admit()
            for s in free:      # a slot that served before, taken again
                if b.live[s] is not None and b.live[s].rid == 2:
                    c = caches_to_numpy(b.caches) if b is pb else \
                        jax.tree.map(np.asarray, b.caches)
                    carried.append(np.abs(c["scan"]["s1"]["C"][:, s]).max())
        b._admit = spy
    want = _serve(jb, J, reqs)
    assert min(gaps) > GAP, f"reference top-2 gap {min(gaps)}"
    got = _serve(pb, T, reqs)
    assert got == want and sorted(got) == [0, 1, 2]
    assert len(carried) == 2 and min(carried) > 0     # the state carried
    np.testing.assert_allclose(carried[1], carried[0], rtol=1e-4)
    jc = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jb.caches))[0])
    pc = caches_to_numpy(pb.caches)
    for path, w in jc.items():
        node = pc
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))


TEXT_ARCHS = ["deepseek-moe-16b", "qwen2-moe-a2.7b", "minitron-8b",
              "gemma3-27b", "mistral-large-123b"]
MODALITY_ARCHS = ["musicgen-large", "qwen2-vl-72b"]


@pytest.fixture(scope="module", params=TEXT_ARCHS)
def text_model(request):
    """One text architecture's SMOKE weights, drawn by ``repro``, in both
    packages, and one jitted ``repro`` decode for its batchers."""
    arch = request.param
    jcfg, pcfg = JC.get_smoke(arch), PC.get_smoke(arch)
    jp = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(9))
    return {arch: (jcfg, pcfg, jp,
                   params_from_numpy(jax.tree.map(np.asarray, jp)),
                   jax.jit(JM.make_decode_step(jcfg)))}


def test_text_arch_batcher_matches_repro(text_model):
    """Four requests on two slots of each of the other five text
    architectures (MoE with shared experts and a sigmoid-gated shared
    expert, an ungated squared-ReLU MLP, 5:1 local:global attention with
    QK-norm, GQA 4:1): the port's tokens are ``repro``'s."""
    arch = next(iter(text_model))
    jb, pb = _batchers(text_model, arch)
    gaps = _record_gaps(jb)
    reqs = [(0, (3, 40), 3), (1, (5, 9, 17), 4), (2, (11, 4), 3),
            (3, (7,), 2)]
    want = _serve(jb, J, reqs)
    assert min(gaps) > GAP, f"reference top-2 gap {min(gaps)}"
    got = _serve(pb, T, reqs)
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert [len(got[r[0]]) for r in reqs] == [r[2] for r in reqs]
    assert pb.ticks == jb.ticks


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_modality_archs_are_refused(arch, monkeypatch):
    """musicgen-large (codebook frames) and qwen2-vl-72b (embeddings) are
    not served by the token batcher: both packages' ``ContinuousBatcher``
    refuse the config and both launchers exit with the same message."""
    from repro.launch import serve as JS
    from repro_torch.launch import serve as PS
    for pkg, cfg in ((JB, JC.get_smoke(arch)), (PB, PC.get_smoke(arch))):
        with pytest.raises(AssertionError, match="token-in/token-out"):
            pkg.ContinuousBatcher(cfg, None, slots=2, max_len=8)
    argv = ["--arch", arch, "--smoke"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        JS.main()
    with pytest.raises(SystemExit) as got:
        PS.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "modality-frontend arch" in str(got.value)


def test_batcher_throttle_passes_over_blocked_requests():
    """``tests/test_qos.py:391`` through both packages."""
    seen = []
    for pkg in (J, T):
        b = object.__new__(pkg.B.ContinuousBatcher)   # queue logic only
        b.queue = deque([pkg.B.Request(rid=0, prompt=[1], tenant=0),
                         pkg.B.Request(rid=1, prompt=[1], tenant=1),
                         pkg.B.Request(rid=2, prompt=[1], tenant=0)])
        b.throttle = lambda req: req.tenant == 0
        got = [b._next_admittable().rid, b._next_admittable(),
               [r.rid for r in b.queue]]
        b.throttle = None
        got.append(b._next_admittable().rid)
        seen.append(got)
    assert seen[0] == seen[1] == [1, None, [0, 2], 0]


def test_model_backed_stream_bridge(models):
    """Engine -> model -> engine (``test_training_serving.py:118``)."""
    seen = []
    for pkg, b in zip((J, T), _batchers(models, "gemma3-1b")):
        ecfg = pkg.EngineConfig(n_streams=16, batch=8, queue=64, max_in=4,
                                max_out=4)
        reg = pkg.Registry(ecfg)
        t = reg.create_tenant("tenant")
        sensor = reg.create_stream(t, "sensor", ["v"])
        feat = reg.create_composite(t, "features", ["v"], [sensor],
                                    transform={"v": "sensor.v * 10"})
        llm = reg.create_composite(t, "llm", ["v"], [feat],
                                   transform={"v": "features.v"},
                                   model_backed=True)
        resp = reg.create_stream(t, "llm_out", ["score"])
        alarm = reg.create_composite(t, "alarm", ["v"], [resp],
                                     transform={"v": "llm_out.score > 0"})
        eng = pkg.create_engine(reg)
        bridge = pkg.Bridge(eng, b)
        bridge.route(llm, resp, prompt_len=4)
        eng.post(sensor, [0.42], ts=1)
        n_req = sum(bridge.pump(s, ts=10) for s in eng.drain())
        done = bridge.drain(ts=10)
        eng.drain()
        seen.append((n_req, [(r.rid, r.prompt, r.output) for r in done],
                     float(eng.value_of(resp)[0]), int(eng.ts_of(resp)),
                     int(eng.ts_of(alarm))))
    assert seen[0][0] == 1 and len(seen[0][1]) == 1
    assert seen[0][4] > 0           # the score re-entered and hit `alarm`
    assert seen[1] == seen[0]


# --------------------------------------------------------------------------
# the bridge's control plane, stub batchers
# --------------------------------------------------------------------------

def _watermark(pkg):
    """``test_qos.py:355``: a backlogged tenant's emissions defer and are
    released once the backlog drains."""
    reg = pkg.Registry.with_capacity(_cfg(pkg))
    t = reg.create_tenant("t")
    a = reg.create_stream(t, "a", ["v"])
    chain = reg.create_composite(t, "x", ["v"], [a], {"v": "in0.v + 1"})
    reg.create_composite(t, "y", ["v"], [chain], {"v": "in0.v + 1"})
    eng = pkg.create_engine(reg)
    eng.drain()
    batcher, submitted = _stub(throttle=True)
    mbs = pkg.Bridge(eng, batcher, watermark=0)
    obs = [batcher.throttle is not None]
    model, _resp = mbs.admit_route(t, "scorer", [a], prompt_len=4)
    eng.post(a, [1.0], ts=1)
    eng.round()                      # chain emission queued: occ > 0
    obs += [eng.tenant_backlog(t) > 0,
            mbs._submit(model.sid, np.ones(4, np.float32)),
            len(mbs.deferred), len(submitted),
            batcher.throttle(SimpleNamespace(tenant=t.tid))]
    eng.drain()
    obs += [eng.tenant_backlog(t), mbs.release_deferred(), len(submitted),
            len(mbs.deferred), submitted[0].tenant == t.tid,
            [int(x) for x in submitted[0].prompt]]
    return obs


def _admit_route(pkg):
    """``test_admission.py:457``: a route admitted and revoked on a
    running engine; a full table refuses."""
    reg = pkg.Registry.with_capacity(_cfg(pkg))
    t = reg.create_tenant("t")
    a = reg.create_stream(t, "a", ["v"])
    eng = pkg.create_engine(reg)
    eng.post(a, [1.0], ts=1)
    eng.drain()
    batcher, _ = _stub()
    mbs = pkg.Bridge(eng, batcher)
    model, resp = mbs.admit_route(t, "scorer", [a], prompt_len=4)
    obs = [model.model_backed, model.sid in mbs.routes, model.sid,
           resp.sid]
    mbs.revoke_route(model)
    obs += [model.sid in mbs.routes, eng.registry.streams[model.sid],
            eng.registry.streams[resp.sid]]
    small = pkg.Registry(_cfg(pkg, n_streams=2))
    ts2 = small.create_tenant("t")
    x = small.create_stream(ts2, "x", ["v"])
    small.create_stream(ts2, "y", ["v"])
    eng2 = pkg.create_engine(small)
    obs += [pkg.Bridge(eng2, batcher).admit_route(ts2, "m", [x]),
            eng2.admission_rejected]
    return obs


def _snapshot_restore(pkg):
    """``test_durability.py:418``: the bridge's control state survives
    JSON and a restored engine."""
    reg = pkg.Registry.with_capacity(_cfg(pkg))
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    eng = pkg.create_engine(reg)
    batcher, submitted = _stub()
    bridge = pkg.Bridge(eng, batcher)
    model, resp = bridge.admit_route(t, "scorer", [src])
    bridge.deferred.append((model.sid, np.ones((4,), np.float32), 3))
    bridge._next_rid = 5
    snap = json.loads(json.dumps(bridge.snapshot()))
    bridge2 = pkg.Bridge(pkg.restore_engine(eng.snapshot()), batcher)
    bridge2.restore(snap)
    r = bridge2.routes[model.sid]
    return [snap, bridge2._next_rid, list(bridge2.routes),
            r.response_stream.sid == resp.sid, r.prompt_len, r.tenant,
            [(s, v.tolist(), i) for s, v, i in bridge2.deferred],
            len(submitted)]


def _resize(pkg):
    """``test_elastic.py:392``: routes survive ``resize`` and ``rebind``
    re-resolves them against a restored engine."""
    reg = pkg.Registry.with_capacity(_cfg(pkg, n_shards=1))
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    model = reg.create_composite(t, "m", ["req"], [src], {"req": "in0.v"},
                                 model_backed=True)
    resp = reg.create_stream(t, "m.response", ["score"])
    eng = pkg.create_engine(reg)
    batcher, submitted = _stub()
    bridge = pkg.Bridge(eng, batcher)
    bridge.route(model, resp)
    eng.post(src, [1.0], 1)
    for sink in eng.drain():
        bridge.pump(sink, ts=1)
    obs = [len(submitted)]
    eng.resize(2)
    obs += [bridge.engine is eng, bridge.engine.cfg.n_shards]
    eng.post(src, [2.0], 10)
    for sink in eng.drain():
        bridge.pump(sink, ts=10)
    engR = pkg.restore_engine(eng.snapshot())
    bridge.rebind(engR)
    obs += [len(submitted), [[int(x) for x in r.prompt] for r in submitted],
            bridge.engine is engR, set(bridge.routes),
            bridge.routes[model.sid].response_stream is
            engR.registry.streams[resp.sid]]
    return obs


def _quarantine(pkg):
    """``test_fault_plane.py:584``: a deferred emission of a source
    quarantined since is dropped at release."""
    cfg = _cfg(pkg, channels=1, batch=4, queue=32, n_consts=8,
               sink_buffer=8, retention_slots=2).validate()
    reg = pkg.Registry.with_capacity(cfg)
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    model = reg.create_composite(t, "m", ["v"], [src], {"v": "src.v"},
                                 model_backed=True)
    resp = reg.create_stream(t, "m.response", ["score"])
    eng = pkg.create_engine(reg)
    batcher, submitted = _stub()
    br = pkg.Bridge(eng, batcher, watermark=0)
    br.route(model, resp)
    br._occ = np.array([10] * cfg.n_tenants)
    obs = [br._submit(model.sid, np.array([1.0], np.float32), 0),
           len(br.deferred)]
    eng.quarantine(model)
    obs += [br.release_deferred(), br.deferred, br.dropped_quarantined]
    eng.unquarantine(model)
    br._refresh_backpressure()
    obs += [br._submit(model.sid, np.array([1.0], np.float32), 0),
            [(r.rid, r.tenant, [int(x) for x in r.prompt])
             for r in submitted]]
    return obs


def _pump_spool(pkg):
    """``test_superstep.py:282``: a superstep's spool is pumped as its
    per-round sinks are, and ``serve`` drives a superstep end to end."""
    def build():
        reg = pkg.Registry.with_capacity(_cfg(pkg))
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])
        m = reg.create_composite(t, "m", ["req"], [a], {"req": "a.v"},
                                 model_backed=True)
        eng = pkg.create_engine(reg)
        batcher, submitted = _stub()
        mbs = pkg.Bridge(eng, batcher)
        mbs.route(m, a)
        return eng, a, mbs, submitted

    (engA, aA, mbsA, subA), (engB, aB, mbsB, subB) = build(), build()
    for eng, a in ((engA, aA), (engB, aB)):
        eng.post(a, [1.0], 1)
        eng.post(a, [2.0], 2)
    nA = sum(mbsA.pump(s, ts=5) for s in engA.spool_sinks(engA.superstep(4)))
    nB = mbsB.pump_spool(engB.superstep(4), ts=5)
    engB.post(aB, [3.0], 9)
    return [nA, nB, len(subA), len(subB),
            [[int(x) for x in r.prompt] for r in subA],
            [[int(x) for x in r.prompt] for r in subB],
            mbsB.serve(ts=10, K=4)]


def _pump_spool_sharded(pkg):
    """``test_superstep.py:321``: on 2 shards ``pump_spool`` submits
    round-major (round, shard, index), as the per-round pump does."""
    def build():
        cfg = pkg.EngineConfig(n_streams=16, batch=8, queue=64, max_in=2,
                               max_out=4, n_shards=2)
        reg = pkg.Registry(cfg)
        t = reg.create_tenant("t")
        a = reg.create_stream(t, "a", ["v"])                 # sid 0, shard 0
        ma = reg.create_composite(t, "ma", ["q"], [a], {"q": "a.v"},
                                  model_backed=True)         # sid 1, shard 0
        md = reg.create_composite(t, "md", ["q"], [ma], {"q": "ma.q"},
                                  model_backed=True)         # sid 2, shard 0
        for i in range(5):
            reg.create_stream(t, f"p{i}", ["v"])             # sids 3..7
        mb = reg.create_composite(t, "mb", ["q"], [a], {"q": "a.v"},
                                  model_backed=True)         # sid 8, shard 1
        mc = reg.create_composite(t, "mc", ["q"], [mb], {"q": "mb.q"},
                                  model_backed=True)         # sid 9, shard 1
        eng = pkg.create_engine(reg)
        mbs = pkg.Bridge(eng, _stub()[0])
        for m in (ma, mb, mc, md):
            mbs.route(m, a)
        return eng, a, mbs

    def order(mbs):     # source sids in rid (submission) order
        return [mbs.inflight[rid].source_sid for rid in sorted(mbs.inflight)]

    (engA, aA, mbsA), (engB, aB, mbsB) = build(), build()
    engA.post(aA, [1.0], 1)
    engB.post(aB, [1.0], 1)
    for sink in engA.spool_sinks(engA.superstep(4)):
        mbsA.pump(sink, ts=5)
    mbsB.pump_spool(engB.superstep(4), ts=5)
    return [order(mbsA), order(mbsB)]


SCENARIOS = {
    "qos_watermark": (_watermark, [True, True, 0, 1, 0, True, 0, 1, 1, 0,
                                   True, None]),
    "admission_admit_route": (_admit_route, None),
    "durability_snapshot_restore": (_snapshot_restore, None),
    "elastic_resize": (_resize, None),
    "fault_quarantine": (_quarantine, None),
    "superstep_pump_spool": (_pump_spool, None),
    "superstep_pump_spool_2_shards": (_pump_spool_sharded,
                                      [[1, 8, 2, 9], [1, 8, 2, 9]]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_bridge_control_plane_matches_repro(name):
    run, pinned = SCENARIOS[name]
    want, got = run(J), run(T)
    assert got == want
    if pinned is not None:           # the original test's assertions
        for w, g in zip(pinned, got):
            if w is not None:
                assert g == w
    if name == "admission_admit_route":
        assert got[:2] == [True, True] and got[4:7] == [False, None, None]
        assert got[7] is None and got[8] >= 1
    elif name == "durability_snapshot_restore":
        assert got[1] == 5 and got[3] and len(got[6]) == 1
    elif name == "elastic_resize":
        assert got[0] >= 1 and got[1:3] == [True, 2] and got[3] > got[0]
        assert got[5] and got[7]
    elif name == "fault_quarantine":
        assert got[:5] == [0, 1, 0, [], 1] and got[5] == 1
    elif name == "superstep_pump_spool":
        assert got[0] == got[1] == got[2] == got[3] > 0 and got[4] == got[5]
        assert got[6] == 1
