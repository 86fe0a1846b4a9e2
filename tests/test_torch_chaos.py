"""The port's chaos-injection harness (``repro_torch.launch.chaos``)
against the JAX package's, on the CPU.

* ``ChaosMonkey``: for a few seeds the same schedule (``manifest()``) and
  the same next draws of the injectors' generator.
* ``poison_payload`` for each kind bitwise, ``hostile_transform`` for each
  mode, and ``corrupt_checkpoint`` in each mode on byte-identical copies
  of one checkpoint directory: the same victim and the same bytes after
  the damage.
* ``tests/test_fault_plane.py``'s checkpoint cases through the port: a
  truncated, bit-flipped or manifest-damaged newest checkpoint falls back
  to the newest valid step, and when every checkpoint is torn the
  restore gives ``None``.
"""
import filecmp
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as P  # noqa: E402
from repro.launch import chaos as JC  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import chaos as PC  # noqa: E402


@pytest.fixture(autouse=True)
def _deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


# --------------------------------------------------------------------------
# the schedule and the injectors against repro
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (17, dict(p_poison=0.15, p_storm=0.0, kill_steps=(70, 150),
              tear_steps=(150,))),
    (50, dict(p_poison=0.5, p_storm=0.3, kill_steps=(3, 3),
              tear_steps=(9,), hostile_steps=(3, 0))),
])
def test_monkey_matches_repro(seed, kw):
    mp, mj = PC.ChaosMonkey(seed, 200, **kw), JC.ChaosMonkey(seed, 200, **kw)
    assert mp.manifest() == mj.manifest() and mp.manifest()
    for step in (0, 3, 9, 150):
        assert ([(e.step, e.kind, e.detail) for e in mp.events_at(step)]
                == [(e.step, e.kind, e.detail) for e in mj.events_at(step)])
    # the injectors' stream: seed + 1, the same next draws
    np.testing.assert_array_equal(mp.rng.integers(0, 2**31, 16),
                                  mj.rng.integers(0, 2**31, 16))
    np.testing.assert_array_equal(mp.rng.standard_normal(8),
                                  mj.rng.standard_normal(8))


@pytest.mark.parametrize("kind", list(PC.POISON_KINDS) + [None])
@pytest.mark.parametrize("channels", [1, 5])
def test_poison_payload_matches_repro(kind, channels):
    assert PC.POISON_KINDS == JC.POISON_KINDS
    rp, rj = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(4):
        a = PC.poison_payload(rp, channels, kind)
        b = JC.poison_payload(rj, channels, kind)
        assert a.dtype == b.dtype == np.float32 and a.shape == (channels,)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        assert not np.isfinite(a).all() or np.abs(a).max() >= 3.0e38
    assert rp.integers(2**31) == rj.integers(2**31)


@pytest.mark.parametrize("mode", ["overflow", "amplify", "bogus"])
def test_hostile_transform_matches_repro(mode):
    chans = ["a", "b", "v"]
    if mode == "bogus":
        for mod in (PC, JC):
            with pytest.raises(ValueError, match="unknown hostile mode"):
                mod.hostile_transform("src", chans, mode)
        with pytest.raises(ValueError, match="unknown poison kind"):
            PC.poison_payload(np.random.default_rng(0), 2, mode)
        return
    got = PC.hostile_transform("src", chans, mode)
    assert got == JC.hostile_transform("src", chans, mode)
    assert sorted(got) == chans


def _poison_rig(**kw):
    """``tests/test_fault_plane.py``'s rig: one tenant, src -> comp."""
    cfg = P.EngineConfig(n_streams=16, n_tenants=4, channels=1, batch=4,
                         queue=32, max_in=4, max_out=4, prog_len=24,
                         n_consts=8, n_temps=12, sink_buffer=8,
                         retention_slots=2, dlq_slots=16, **kw).validate()
    reg = P.Registry.with_capacity(cfg)
    t = reg.create_tenant("t")
    src = reg.create_stream(t, "src", ["v"])
    comp = reg.create_composite(t, "comp", ["v"], [src],
                                {"v": "src.v * 2.0"})
    return P.create_engine(reg, device="cpu"), src, comp


def _ckpt_rig(path, n_ckpts=3):
    eng, src, comp = _poison_rig(checkpoint_every=1)
    eng.checkpoint_to(str(path), keep=n_ckpts + 2)
    for i in range(n_ckpts):
        eng.post(src, [float(i)], ts=i + 1)
        eng.superstep(1)
    eng._ckpt.wait()
    return eng, sorted(ckpt.all_steps(str(path)))


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "manifest", None])
def test_corrupt_checkpoint_matches_repro(tmp_path, mode):
    """Both injectors on byte-identical copies of one checkpoint
    directory, with generators of one seed: the same victim, the same
    bytes after the damage, and the generators left in the same state."""
    a, b = tmp_path / "port", tmp_path / "repro"
    _, steps = _ckpt_rig(a)
    shutil.copytree(a, b)
    for seed in range(3):
        for step in (None, steps[0]):
            rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
            vp = PC.corrupt_checkpoint(str(a), rp, mode=mode, step=step)
            vj = JC.corrupt_checkpoint(str(b), rj, mode=mode, step=step)
            assert os.path.relpath(vp, a) == os.path.relpath(vj, b)
            assert rp.integers(2**31) == rj.integers(2**31)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == len(files)
    assert not all(ckpt.verify(str(a), s) for s in steps)
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (PC, JC):
        assert mod.corrupt_checkpoint(str(empty),
                                      np.random.default_rng(0)) is None


# --------------------------------------------------------------------------
# tests/test_fault_plane.py's checkpoint cases, through the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["truncate", "bitflip", "manifest"])
def test_corrupt_newest_falls_back_to_older(tmp_path, mode):
    eng, steps = _ckpt_rig(tmp_path)
    assert len(steps) >= 2
    path = str(tmp_path)
    if mode == "bitflip":
        # flip the last data byte of a leaf by hand (deterministic: an
        # rng-placed flip may land in npy header padding and stay benign)
        d = os.path.join(path, f"step_{steps[-1]:08d}")
        leaf = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
        with open(os.path.join(d, leaf), "r+b") as f:
            f.seek(-1, 2)
            b = f.read(1)
            f.seek(-1, 2)
            f.write(bytes([b[0] ^ 0x80]))
    else:
        assert PC.corrupt_checkpoint(path, np.random.default_rng(0),
                                     mode=mode) is not None
    assert not ckpt.verify(path, steps[-1])
    assert ckpt.verify(path, steps[-2])
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load(path, steps[-1])           # explicit step: hard error
    got, _, _ = ckpt.load_latest_valid(path)
    assert got == steps[-2]                  # newest *valid* wins
    eng2 = P.restore_engine(path, device="cpu")
    assert eng2 is not None and eng2._steps_done == steps[-2]


def test_all_checkpoints_corrupt_restores_none(tmp_path):
    _, steps = _ckpt_rig(tmp_path)
    rng = np.random.default_rng(1)
    for s in steps:
        PC.corrupt_checkpoint(str(tmp_path), rng, mode="manifest", step=s)
    assert ckpt.load_latest_valid(str(tmp_path)) == (None, None, None)
    assert P.restore_engine(str(tmp_path), device="cpu") is None
