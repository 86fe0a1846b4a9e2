"""The port's checkpoint module against the JAX package's: the same trees
give the same directories byte for byte, each package reads the other's
checkpoints, and the guarantees of ``tests/test_checkpoint.py`` hold in
the port (atomic and fsynced saves, colliding keys disambiguated,
``keep`` validated and honoured, a torn newest checkpoint skipped by the
latest-valid readers, asynchronous saves that land with their
``extra``)."""
import collections
import filecmp
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import ckpt as J  # noqa: E402
from repro_torch.checkpoint import ckpt as P  # noqa: E402


class Pair(NamedTuple):
    left: object
    right: object


def _tree(seed=0):
    """Nested dicts (one ordered), lists, tuples, a NamedTuple, ``None``,
    empty containers, scalars and arrays of several dtypes, with keys
    that collide once sanitised (``a/b``, ``a_b``, ``a.b``)."""
    rng = np.random.default_rng(seed)
    return {
        "a": {"b": rng.standard_normal((3, 2)).astype(np.float32),
              "none": None},
        "a_b": np.int32(7),
        "a.b": np.zeros((0, 2), np.float32),
        "seq": [rng.integers(-9, 9, 4, dtype=np.int8),
                (np.float64(1.5), rng.random(3) < 0.5)],
        "pair": Pair(np.arange(5, dtype=np.int32), [np.float32(-0.0)]),
        "ordered": collections.OrderedDict(
            [("z", np.int64(1)), ("y", np.uint8(2))]),
        "empty": [],
    }


def test_flatten_matches_jax_tree_paths():
    """Leaf keys and their order are those of
    ``jax.tree_util.tree_flatten_with_path`` (sorted dict keys, an
    OrderedDict's own order, sequence indices, ``.field`` for a
    NamedTuple, ``None`` and empty containers leafless)."""
    tree = _tree()
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = P._flatten(tree)
    assert [k for k, _ in got] == want
    for (_, x), (_, y) in zip(got, jax.tree_util.tree_flatten_with_path(
            tree)[0]):
        assert x is y


@pytest.mark.parametrize("writer,reader", [(J, P), (P, J)],
                         ids=["repro_to_port", "port_to_repro"])
def test_checkpoints_cross_packages(tmp_path, writer, reader):
    """One package's ``save`` is read by the other's ``load`` and
    ``restore``, every leaf bitwise; both packages write the same tree
    into the same files, manifest included, byte for byte."""
    tree = _tree(1)
    extra = {"kind": "single", "registry": {"cfg": {"n_shards": 2}}}
    for mod, name in ((writer, "w"), (reader, "r")):
        mod.save(str(tmp_path / name), 5, tree, extra=extra)
    step_w, step_r = (str(tmp_path / n / "step_00000005") for n in "wr")
    files = sorted(os.listdir(step_w))
    assert files == sorted(os.listdir(step_r))
    match, mismatch, errors = filecmp.cmpfiles(step_w, step_r, files,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(files)
    leaves, got_extra = reader.load(str(tmp_path / "w"), 5)
    assert got_extra == extra
    want = dict(P._flatten(tree))
    assert set(leaves) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert leaves[k].dtype == v.dtype and leaves[k].shape == v.shape, k
        assert leaves[k].tobytes() == v.tobytes(), k
    back = reader.restore(str(tmp_path / "w"), 5, tree)
    assert isinstance(back["pair"], Pair)
    assert list(back["ordered"]) == ["z", "y"]
    assert back["a"]["none"] is None and back["empty"] == []
    np.testing.assert_array_equal(np.asarray(back["seq"][1][1]),
                                  tree["seq"][1][1])


def test_save_of_tensors_and_restore_to_a_device(tmp_path):
    """Torch leaves are saved as their numpy arrays; ``restore(device=)``
    gives tensors there in the like-tree's structure."""
    tree = {"t": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "n": Pair(torch.tensor([-0.0, 1.5]), None)}
    P.save(str(tmp_path), 1, tree)
    leaves, extra = J.load(str(tmp_path), 1)
    assert extra is None
    np.testing.assert_array_equal(leaves["t"], tree["t"].numpy())
    assert leaves["n/.left"].view(np.int32)[0] == np.int32(-2 ** 31)
    got = P.restore(str(tmp_path), 1, tree, device="cpu")
    assert isinstance(got["t"], torch.Tensor) and got["n"].right is None
    assert torch.equal(got["t"], tree["t"])


def test_sync_flag_fsyncs_or_not(tmp_path, monkeypatch):
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd),
                                                 real(fd))[1])
    P.save(str(tmp_path / "s"), 1, {"a": np.arange(4), "b": np.ones(2)})
    assert len(calls) == 5          # 2 leaves, manifest, tmp dir, parent
    calls.clear()
    out = P.save(str(tmp_path / "n"), 2, {"a": np.arange(4)}, sync=False)
    assert calls == [] and not os.path.exists(out + ".tmp")


@pytest.mark.parametrize("keys", [["a/b", "a_b", "a.b"],
                                  ["x/y/z", "x_y.z", "x_y_z", "x/y_z"]])
def test_colliding_keys_disambiguate_like_repro(keys):
    fn = P._leaf_filenames(keys)
    assert fn == J._leaf_filenames(keys)
    assert len(set(fn.values())) == len(keys)
    with pytest.raises(ValueError, match="duplicate"):
        P._leaf_filenames(keys + keys[:1])


def test_keep_is_validated_and_honoured(tmp_path):
    for bad in (0, -1):
        with pytest.raises(ValueError, match="keep"):
            P.CheckpointManager(str(tmp_path), keep=bad)
    mgr = P.CheckpointManager(str(tmp_path), keep=1)
    for step in (1, 2, 3):
        mgr.save_sync(step, {"a": np.full((2,), step)})
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
    step, leaves, _ = mgr.load_latest()
    assert step == 3 and P.latest_step(str(tmp_path)) == 3
    np.testing.assert_array_equal(leaves["a"], [3, 3])


def test_torn_newest_checkpoint_falls_back(tmp_path):
    """A truncated leaf of the newest checkpoint: the latest-valid readers
    fall back to the one before it, an explicit load of the newest raises
    ``CheckpointCorrupt``, and ``verify`` says which is whole."""
    mgr = P.CheckpointManager(str(tmp_path), keep=3)
    like = {"a": np.zeros((8,), np.float32), "b": np.zeros((2,), np.int32)}
    for step in (1, 2):
        mgr.save_sync(step, {"a": np.full((8,), step, np.float32),
                             "b": np.array([step, -step], np.int32)},
                      extra={"step": step})
    leaf = tmp_path / "step_00000002" / "a.npy"
    leaf.write_bytes(leaf.read_bytes()[:-5])
    assert not P.verify(str(tmp_path), 2) and P.verify(str(tmp_path), 1)
    with pytest.raises(P.CheckpointCorrupt):
        P.load(str(tmp_path), 2)
    step, leaves, extra = P.load_latest_valid(str(tmp_path))
    assert step == 1 and extra == {"step": 1}
    np.testing.assert_array_equal(leaves["b"], [1, -1])
    step, tree = mgr.restore_latest(like)
    assert step == 1 and tree["a"][0] == 1.0
    with pytest.raises(J.CheckpointCorrupt):    # repro reads the same damage
        J.load(str(tmp_path), 2)


def test_save_async_lands_with_extra(tmp_path):
    """The device->host copy happens on the caller's thread: changing the
    tensor after ``save_async`` returns does not reach the checkpoint."""
    mgr = P.CheckpointManager(str(tmp_path), keep=3)
    x = torch.arange(3)
    mgr.save_async(7, {"x": x, "n": np.int32(4)}, extra={"kind": "test"})
    x.add_(100)
    step, leaves, extra = mgr.load_latest()
    assert step == 7 and extra == {"kind": "test"}
    np.testing.assert_array_equal(leaves["x"], np.arange(3))
    assert mgr.peek_latest() == (7, {"kind": "test"})
    assert P.peek_extra(str(tmp_path)) == J.peek_extra(str(tmp_path))
