"""The port's self-healing supervisor (``repro_torch.launch.supervise``),
on the CPU.

* ``tests/test_fault_plane.py``'s supervisor cases through the port:
  recovery from an injected ``ShardKill`` bitwise equal to an undisturbed
  twin, a torn newest checkpoint skipped, blame and escalation on the
  second strike, ``RuntimeError("recovery failed")`` when no checkpoint
  exists, and the stall watchdog.
* One seeded chaos drill through both packages at 1 and 2 shards (poison
  payloads, a hostile overflow program, a storm, a kill, then a torn
  newest checkpoint and a kill, the breaker armed): the same incident log
  field for field but the downtime, the same checkpoint directories byte
  for byte, final engines bitwise equal to each other and to an
  undisturbed twin that took the same feed.
* A restore keeps the failed engine's device, fan-out and kernel choice.
"""
import dataclasses
import filecmp
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.launch import chaos as JC  # noqa: E402
from repro.launch import supervise as JS  # noqa: E402
from repro_torch.kernels.stream_dispatch.ops import make_fanout  # noqa: E402
from repro_torch.launch import chaos as PC  # noqa: E402
from repro_torch.launch import supervise as PS  # noqa: E402
from repro_torch.launch import Supervisor, supervised_run  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _cfg(mod, **kw):
    base = dict(n_streams=16, n_tenants=4, channels=1, batch=4, queue=32,
                max_in=4, max_out=4, prog_len=24, n_consts=8, n_temps=12,
                sink_buffer=8, retention_slots=2, dlq_slots=16)
    base.update(kw)
    return mod.EngineConfig(**base).validate()


def _engine(mod, reg, **kw):
    return mod.create_engine(reg, **({"device": "cpu"} if mod is P else {}),
                             **kw)


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(a, b, where, meta=True):
    """Every snapshot array bitwise (and the registry mirror and host
    counters, unless ``meta`` is false)."""
    (xa, ma), (xb, mb) = a.snapshot(), b.snapshot()
    assert sorted(xa) == sorted(xb), where
    for k in xa:
        u, v = _bits(xa[k]), _bits(xb[k])
        assert u.dtype == v.dtype and u.shape == v.shape, f"{where} {k}"
        np.testing.assert_array_equal(u, v, err_msg=f"{where} {k}")
    if meta:
        assert ma == mb, where


# --------------------------------------------------------------------------
# tests/test_fault_plane.py's supervisor cases, through the port
# --------------------------------------------------------------------------

def _sup_rig(n_steps, poison_steps=(), ck_every=2, threshold=2):
    cfg = _cfg(P, checkpoint_every=ck_every, fault_window=8,
               fault_threshold=threshold)
    reg = P.Registry.with_capacity(cfg)
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    comp = reg.create_composite(t, "comp", ["v"], [src],
                                {"v": "src.v * 2.0"})
    eng = _engine(P, reg)
    sid = src.sid

    def feed(e, step):
        bad = step in poison_steps
        e.post(sid, [np.nan if bad else float(step)], ts=step + 1)
    return eng, comp, feed


def test_supervisor_recovers_bit_identical(tmp_path):
    n_steps, kill_at = 10, 6

    def chaos(e, step):
        if step == kill_at:
            raise PC.ShardKill("injected")

    eng, comp, feed = _sup_rig(n_steps, poison_steps=(2,))
    report = supervised_run(eng, str(tmp_path / "a"), n_steps,
                            feed=feed, chaos=chaos, K=1)
    assert report.recovered and len(report.incidents) == 1
    inc = report.incidents[0]
    assert inc.kind == "crash" and "ShardKill" in inc.detail
    assert 0 < inc.restored_step <= kill_at
    assert inc.replayed_steps == kill_at - inc.restored_step + 1
    assert report.engine is not eng
    assert report.engine._steps_done == n_steps
    assert report.mttr_s > 0
    twin, _, tfeed = _sup_rig(n_steps, poison_steps=(2,), ck_every=0)
    for step in range(n_steps):
        tfeed(twin, step)
        twin.superstep(1)
    assert_same(report.engine, twin, "recovered vs twin", meta=False)
    log = json.loads(report.to_json())
    assert log["incidents"][0]["step"] == kill_at
    assert log["recovered"] and log["mttr_s"] == report.mttr_s


def test_supervisor_skips_torn_checkpoint(tmp_path):
    n_steps, kill_at = 10, 7
    rng = np.random.default_rng(3)

    def chaos(e, step):
        if step == kill_at:
            e._ckpt.wait()
            assert PC.corrupt_checkpoint(str(tmp_path), rng,
                                         mode="truncate") is not None
            raise PC.ShardKill("kill with torn newest")

    eng, comp, feed = _sup_rig(n_steps)
    report = supervised_run(eng, str(tmp_path), n_steps,
                            feed=feed, chaos=chaos, K=1)
    assert report.recovered
    inc = report.incidents[0]
    # the newest (torn) checkpoint was at steps_done 6; recovery must
    # have fallen back past it
    assert inc.restored_step < 6
    assert report.engine._steps_done == n_steps


def test_supervisor_blame_and_escalation(tmp_path):
    # breaker disarmed (threshold=0): faults count but never auto-trip,
    # so only the supervisor's escalation can quarantine the offender
    n_steps = 12
    kills = {4, 8}

    def chaos(e, step):
        if step in kills:
            raise PC.ShardKill("injected")

    eng, comp, feed = _sup_rig(n_steps, poison_steps=(1, 2, 3), threshold=0)
    sup = Supervisor(eng, str(tmp_path), feed=feed, chaos=chaos, K=1,
                     blame_faults=1, escalate_after=2)
    report = sup.run(n_steps)
    assert report.recovered and len(report.incidents) == 2
    assert report.incidents[0].blamed == [comp.sid]
    assert report.incidents[0].escalated == []
    assert report.incidents[1].blamed == [comp.sid]
    assert report.incidents[1].escalated == [comp.sid]   # 2nd strike
    assert sup.engine.is_quarantined(comp.sid)


def test_supervisor_gives_up_without_any_checkpoint(tmp_path):
    def chaos(e, step):
        if step == 0:                        # dies before any save lands
            raise PC.ShardKill("early death")

    eng, comp, feed = _sup_rig(4, ck_every=50)
    sup = Supervisor(eng, str(tmp_path), feed=feed, chaos=chaos, K=1,
                     max_retries=2, backoff0_s=0.01)
    with pytest.raises(RuntimeError, match="recovery failed"):
        sup.run(4)
    assert sup.last_report.recovered is False
    assert sup.incidents[-1].retries == 2


def test_supervisor_stall_watchdog(tmp_path):
    slow = {3}

    def chaos(e, step):
        if step in slow:
            time.sleep(0.2)

    eng, comp, feed = _sup_rig(6)
    sup = Supervisor(eng, str(tmp_path), feed=feed, chaos=chaos, K=1,
                     step_budget_s=30.0)     # generous for the first step
    sup.step(0)
    sup.step_budget_s = 0.15                 # now arm a tight budget
    incs = [sup.step(s) for s in range(1, 6)]
    stalls = [i for i in incs if i is not None and i.kind == "stall"]
    assert len(stalls) >= 1 and stalls[0].step == 3
    assert "budget 0.150s" in stalls[0].detail
    assert sup.engine._steps_done == 6


# --------------------------------------------------------------------------
# the restore keeps the engine's device, fan-out and kernel choice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
def test_restore_keeps_device_fanout_and_use_kernel(tmp_path, n_shards):
    """A CPU engine with ``use_kernel=False`` and a non-default fan-out
    comes back from a crash on the CPU with both."""
    cfg = _cfg(P, checkpoint_every=1, n_shards=n_shards)
    reg = P.Registry.with_capacity(cfg)
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    reg.create_composite(t, "comp", ["v"], [src], {"v": "src.v + 1.0"})
    fan = make_fanout(use_kernel=False)
    eng = _engine(P, reg, fanout_fn=fan, use_kernel=False)

    def chaos(e, step):
        if step == 2:
            e._ckpt.wait()
            raise PC.ShardKill("kill")

    def feed(e, step):
        e.post(src.sid, [float(step)], ts=step + 1)

    report = supervised_run(eng, str(tmp_path), 4, feed=feed, chaos=chaos,
                            K=1)
    got = report.engine
    assert report.recovered and got is not eng
    assert got.device == torch.device("cpu")
    assert got._fanout_fn is fan and got.use_kernel is False
    assert got.cfg.n_shards == n_shards


# --------------------------------------------------------------------------
# the chaos drill, through both packages
# --------------------------------------------------------------------------

SEED, N_STEPS, K = 50, 12, 2
KILLS, TEARS, HOSTILE = (5, 10), (10,), (4,)


def _drill_monkey(mod):
    return mod.ChaosMonkey(SEED, N_STEPS, p_poison=0.35, p_storm=0.1,
                           kill_steps=KILLS, tear_steps=TEARS,
                           hostile_steps=HOSTILE)


def _drill_engine(mod, n_shards):
    """Tenant p (two sources, a composite over them, and a second one
    whose program the drill swaps for a hostile one) beside tenant q (a
    source and its composite), the breaker armed."""
    cfg = _cfg(mod, n_shards=n_shards, superstep=K, checkpoint_every=2,
               fault_window=8, fault_threshold=2)
    reg = mod.Registry.with_capacity(cfg)
    p, q = reg.create_tenant("p"), reg.create_tenant("q")
    p0 = reg.create_stream(p, "p0", ["v"])
    p1 = reg.create_stream(p, "p1", ["v"])
    reg.create_composite(p, "pc", ["v"], [p0, p1], {"v": "p0.v * 2.0 + p1.v"})
    reg.create_composite(p, "ph", ["v"], [p0, p1], {"v": "p0.v - p1.v"})
    q0 = reg.create_stream(q, "q0", ["v"])
    reg.create_composite(q, "qc", ["v"], [q0], {"v": "q0.v + 1.0"})
    return _engine(mod, reg)


def _drill_feed(C, monkey):
    """Step ``step``'s posts, a pure function of the step: one SU on each
    source, a poisoned payload on p0 at the monkey's poison steps, a storm
    over p's sources at its storm steps, the hostile swap of ``ph`` at
    its hostile steps; the payload draws on a generator seeded by the
    step."""
    def feed(e, step):
        streams = e.registry.streams
        by = {s.name: s for s in streams if s is not None}
        rng = np.random.default_rng([SEED, step])
        kinds = {ev.kind: ev.detail for ev in monkey.events_at(step)}
        ts = 100 * step + 1
        if "poison" in kinds:
            C.inject_payload_corruption(e, by["p0"].sid, ts, rng,
                                        kinds["poison"])
        else:
            e.post(by["p0"].sid, [float(step)], ts=ts)
        e.post(by["p1"].sid, [0.5 * step], ts=ts)
        e.post(by["q0"].sid, [float(-step)], ts=ts)
        if "storm" in kinds:
            C.inject_ingest_storm(e, [by["p0"], by["p1"]], ts + 1, rng, n=6)
        if "hostile" in kinds:
            C.inject_hostile_program(e, by["ph"], [by["p0"], by["p1"]], rng)
    return feed


def _drill(mod, sup_mod, C, n_shards, path):
    monkey = _drill_monkey(C)

    def chaos(e, step):
        kinds = {ev.kind for ev in monkey.events_at(step)}
        if "tear" in kinds:
            e._ckpt.wait()
            assert C.corrupt_checkpoint(path, monkey.rng) is not None
        if "kill" in kinds:
            e._ckpt.wait()
            raise C.ShardKill(f"drill kill @{step}")

    eng = _drill_engine(mod, n_shards)
    report = sup_mod.supervised_run(eng, path, N_STEPS,
                                    feed=_drill_feed(C, monkey), chaos=chaos,
                                    K=K)
    report.engine._ckpt.wait()
    return monkey, report


def _files(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_drill_matches_repro(tmp_path, n_shards):
    pj, pp = str(tmp_path / "repro"), str(tmp_path / "port")
    mj, rj = _drill(J, JS, JC, n_shards, pj)
    mp, rp = _drill(P, PS, PC, n_shards, pp)
    assert mp.manifest() == mj.manifest()
    kinds = {e["kind"] for e in mp.manifest()}
    assert kinds == {"poison", "storm", "hostile", "kill", "tear"}
    assert rp.recovered and rj.recovered and len(rp.incidents) == 2

    def log(r):
        return [{k: v for k, v in dataclasses.asdict(i).items()
                 if k != "downtime_s"} for i in r.incidents]
    assert log(rp) == log(rj)
    first, second = rp.incidents
    assert [first.step, second.step] == list(KILLS)
    assert first.restored_step == 4 and second.restored_step < 10
    assert second.blamed and set(second.blamed) >= set(first.blamed)
    # the checkpoint directories, file for file and byte for byte
    files = _files(pp)
    assert files == _files(pj) and files
    match, mismatch, errors = filecmp.cmpfiles(pp, pj, files, shallow=False)
    assert (mismatch, errors) == ([], [])
    assert_same(rp.engine, rj.engine, "port vs repro")
    # an undisturbed port twin: the same feed, no kills or tears, the
    # supervisor's escalations applied after the same steps
    twin = _drill_engine(P, n_shards)
    feed = _drill_feed(PC, _drill_monkey(PC))
    escalated = {i.step: i.escalated for i in rp.incidents}
    for step in range(N_STEPS):
        feed(twin, step)
        twin.superstep(K)
        for sid in escalated.get(step, ()):
            twin.quarantine(sid)
    assert_same(rp.engine, twin, "recovered vs twin")
    fc = rp.engine.fault_counters()
    assert fc["quarantined"].any() and fc["fault_total"].sum() > 0
