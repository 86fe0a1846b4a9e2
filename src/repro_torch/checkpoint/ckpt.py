"""Atomic, checksummed, async checkpoints — the PyTorch port of the JAX
package's ``repro.checkpoint.ckpt``, with the same on-disk format byte for
byte, so each package reads the other's checkpoint directories.

  * **atomic** — a checkpoint directory is written as ``step_N.tmp`` and
    renamed to ``step_N`` only after every leaf, the manifest and the
    directory itself are fsynced (``sync=True``, the default); a crash
    mid-write never corrupts the latest checkpoint.  ``sync=False`` skips
    the fsync barrier — the rename is still atomic against *process*
    death, but a machine crash can lose a just-renamed checkpoint to the
    page cache.  That is the async-manager path:
    `CheckpointManager.save_async` trades the barrier for I/O overlap,
    and the previous checkpoint remains the durable fallback;
  * **async** — `CheckpointManager.save_async` copies tensors to host
    numpy on the caller's thread (blocking only for the device->host
    copy) and writes in a background thread;
  * **layout-free** — leaves are stored as whole numpy arrays with a JSON
    manifest of file names, shapes, dtypes and CRCs; :func:`restore`
    places each leaf on the device the caller names;
  * **self-pruning** — keeps the newest ``keep`` checkpoints (``keep``
    must be >= 1; the newest checkpoint is never pruned).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
numpy arrays, numpy or Python scalars, or torch tensors.  Leaf keys and
their order are those of ``jax.tree_util.tree_flatten_with_path``: dict
keys sorted (an ``OrderedDict`` keeps its order), a sequence element by
its index, a NamedTuple field as ``.name``, path parts joined by ``/``;
``None`` and empty containers hold no leaf.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class CheckpointCorrupt(Exception):
    """A checkpoint failed integrity verification: a leaf or manifest is
    missing, truncated, unparsable, or fails its CRC — distinct from
    ``FileNotFoundError`` (the whole step directory is gone, e.g. pruned).
    Latest-valid readers (:func:`load_latest_valid`,
    ``CheckpointManager.load_latest``/``restore_latest`` and
    ``restore_engine(step=None)``) catch this and fall back to the next
    older checkpoint; explicit-step reads surface it to the caller."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _host(leaf) -> Any:
    """A leaf as host data: a torch tensor becomes a numpy array of its
    own (a copy from the device, or of a CPU tensor's storage, which the
    caller may change later); anything else passes through."""
    if hasattr(leaf, "detach") and hasattr(leaf, "cpu"):
        return leaf.detach().to("cpu", copy=True).numpy()
    return leaf


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_keys(node: dict) -> list:
    """A dict's keys in flatten order: sorted, except an ``OrderedDict``'s
    own order."""
    return list(node) if isinstance(node, collections.OrderedDict) \
        else sorted(node)


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(path part, child)`` pairs of a container node in flatten order,
    or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in _dict_keys(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of ``tree`` in the JAX package's order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for part, child in kids:
            walk(child, path + [part])

    walk(tree, [])
    return out


def _unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            got = {k: build(node[k]) for k in _dict_keys(node)}
            if isinstance(node, collections.OrderedDict):
                return type(node)(got)
            return {k: got[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def _leaf_filenames(keys: List[str]) -> Dict[str, str]:
    """Map each leaf key to a unique ``.npy`` filename.

    Sanitization (``/`` and friends -> ``_``) can collide — ``a/b`` and
    ``a_b`` both sanitize to ``a_b`` — so collisions are disambiguated
    deterministically in key order (``a_b.npy``, ``a_b.1.npy``, ...) and
    any residual duplicate is a hard error."""
    if len(set(keys)) != len(keys):
        dupes = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(f"duplicate pytree leaf keys: {dupes}")
    fnames: Dict[str, str] = {}
    used = set()
    for key in keys:
        base = re.sub(r"[^A-Za-z0-9_.-]", "_", key)
        name, n = base, 0
        while name in used:
            n += 1
            name = f"{base}.{n}"
        used.add(name)
        fnames[key] = name + ".npy"
    if len(set(fnames.values())) != len(keys):
        raise ValueError("leaf filename disambiguation failed")
    return fnames


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save(path: str, step: int, tree, *, sync: bool = True,
         extra: Optional[dict] = None) -> str:
    """Write one checkpoint atomically.  Returns the final directory.

    ``sync=True`` fsyncs every leaf file, the manifest, and the checkpoint
    directory before the rename (and the parent directory after), so the
    rename is a durability barrier.  ``sync=False`` skips the fsyncs — the
    async-manager path.  ``extra`` is an optional JSON-able dict stored in
    the manifest and returned by :func:`load`."""
    final = _step_dir(path, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    fnames = _leaf_filenames([k for k, _ in flat])
    manifest: Dict[str, Dict] = {}
    for key, leaf in flat:
        arr = np.asarray(_host(leaf))
        fname = fnames[key]
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            if sync:
                f.flush()
                os.fsync(f.fileno())
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": str(arr.dtype), "crc32": _crc(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest, "extra": extra,
                   "manifest_crc32": _manifest_crc(manifest)}, f)
        if sync:
            f.flush()
            os.fsync(f.fileno())
    if sync:
        _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if sync:
        _fsync_dir(path)
    return final


def all_steps(path: str) -> List[int]:
    """Every checkpoint step present under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(path)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def _manifest_crc(leaves: Dict[str, Dict]) -> int:
    """Checksum over the manifest's leaf table itself (names, shapes,
    dtypes, per-leaf CRCs) — catches a truncated/edited manifest even when
    every surviving leaf file is individually intact."""
    return zlib.crc32(
        json.dumps(leaves, sort_keys=True).encode("utf-8"))


def _read_manifest(d: str) -> dict:
    """Parse and self-verify one checkpoint's manifest.  Raises
    ``FileNotFoundError`` when the step directory is gone entirely and
    :class:`CheckpointCorrupt` when the manifest is unreadable, truncated
    or fails its own checksum.  Manifests without ``manifest_crc32``
    (older writers) pass without integrity cover."""
    if not os.path.isdir(d):
        raise FileNotFoundError(d)
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorrupt(f"{d}: manifest missing") from e
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(f"{d}: manifest unreadable: {e}") from e
    want = m.get("manifest_crc32")
    if want is not None and _manifest_crc(m["leaves"]) != want:
        raise CheckpointCorrupt(f"{d}: manifest checksum mismatch")
    return m


def _load_leaf(d: str, key: str, info: Dict) -> np.ndarray:
    """Read and verify one leaf file; :class:`CheckpointCorrupt` on any
    damage (missing file, truncation, npy parse failure, CRC mismatch)."""
    try:
        arr = np.load(os.path.join(d, info["file"]))
    except (OSError, ValueError, EOFError) as e:
        raise CheckpointCorrupt(f"{d}: leaf {key!r} unreadable: {e}") from e
    if tuple(arr.shape) != tuple(info.get("shape", arr.shape)) \
            or str(arr.dtype) != info.get("dtype", str(arr.dtype)):
        raise CheckpointCorrupt(
            f"{d}: leaf {key!r} shape/dtype drifted from manifest")
    want = info.get("crc32")
    if want is not None and _crc(arr) != want:
        raise CheckpointCorrupt(f"{d}: leaf {key!r} checksum mismatch")
    return arr


def verify(path: str, step: int) -> bool:
    """Full integrity pass over checkpoint ``step`` (manifest and every
    leaf): True when clean, False on any damage or a missing step
    directory (``load``/``restore`` raise instead)."""
    d = _step_dir(path, step)
    try:
        m = _read_manifest(d)
        for key, info in m["leaves"].items():
            _load_leaf(d, key, info)
    except (CheckpointCorrupt, FileNotFoundError):
        return False
    return True


def load(path: str, step: int) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Read every leaf of checkpoint ``step`` without a like-tree.

    Returns ``(leaves, extra)``: ``leaves`` maps each flattened key to its
    host array, ``extra`` is the dict passed to :func:`save` (or None).
    Every leaf and the manifest itself are checksum-verified; damage
    raises :class:`CheckpointCorrupt`."""
    d = _step_dir(path, step)
    m = _read_manifest(d)
    leaves = {key: _load_leaf(d, key, info)
              for key, info in m["leaves"].items()}
    return leaves, m.get("extra")


def load_latest_valid(path: str
                      ) -> Tuple[Optional[int], Optional[Dict], Optional[dict]]:
    """Newest checkpoint that passes verification: walk the steps newest
    to oldest, skipping any that raise :class:`CheckpointCorrupt` (torn
    write, bit-flip, truncation) or vanished mid-read.  Returns ``(step,
    leaves, extra)``, or ``(None, None, None)`` when no valid checkpoint
    exists."""
    for step in reversed(all_steps(path)):
        try:
            leaves, extra = load(path, step)
            return step, leaves, extra
        except (CheckpointCorrupt, FileNotFoundError):
            continue
    return None, None, None


def peek_extra(path: str, step: Optional[int] = None
               ) -> Tuple[Optional[int], Optional[dict]]:
    """Read only the manifest's ``extra`` dict of checkpoint ``step``
    (newest when None) — no leaf I/O.  Returns ``(step, extra)``, or
    ``(None, None)`` when no checkpoint exists.  An engine snapshot's
    ``extra`` carries ``kind`` ("single"/"sharded") and
    ``registry.cfg`` (``n_shards``, ``partition``, capacities), so an
    operator can pick the shard count of a restore without loading an
    array."""
    if step is None:
        step = latest_step(path)
        if step is None:
            return None, None
    with open(os.path.join(_step_dir(path, step), "manifest.json")) as f:
        return step, json.load(f).get("extra")


def restore(path: str, step: int, like, *, device=None):
    """Rebuild the tree of ``like`` (leaves with a ``shape``, or anything)
    from checkpoint ``step``.  Leaves come back as numpy arrays, or as
    torch tensors on ``device`` when one is given."""
    d = _step_dir(path, step)
    manifest = _read_manifest(d)["leaves"]
    leaves = []
    for key, leaf in _flatten(like):
        arr = _load_leaf(d, key, manifest[key])
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{expect}")
        if device is not None:
            import torch
            arr = torch.from_numpy(arr).to(device)
        leaves.append(arr)
    return _unflatten(like, leaves)


class CheckpointManager:
    """Async writer and pruner over one checkpoint directory.

    All disk mutation (save, prune) and the list-then-read of restore run
    under one lock, so ``restore_latest``/``load_latest`` never read a
    checkpoint that a background prune is deleting."""

    def __init__(self, path: str, keep: int = 3):
        if keep < 1:
            raise ValueError(
                f"keep must be >= 1, got {keep}: keep=0 would delete every "
                "checkpoint the moment it lands")
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        os.makedirs(path, exist_ok=True)

    def wait(self):
        """Block until any in-flight background save (and its prune)
        lands."""
        t = self._thread
        if t is not None:
            t.join()
            if self._thread is t:       # don't clobber a newer save
                self._thread = None

    def save_async(self, step: int, tree, extra: Optional[dict] = None) -> None:
        """Device->host copy now, on this thread; the disk writes in the
        background (``sync=False``: see the module docstring)."""
        self.wait()
        host_tree = _unflatten(tree, [np.asarray(_host(x))
                                      for _, x in _flatten(tree)])

        def work():
            with self._lock:
                save(self.path, step, host_tree, sync=False, extra=extra)
                self._prune()

        t = threading.Thread(target=work, daemon=True)
        t.start()                       # started before it is published, so
        self._thread = t                # a concurrent wait() can always join

    def save_sync(self, step: int, tree, extra: Optional[dict] = None) -> str:
        """Fully-synced (fsync-barrier) save on the calling thread."""
        self.wait()
        with self._lock:
            out = save(self.path, step, tree, sync=True, extra=extra)
            self._prune()
        return out

    def restore_latest(self, like, device=None):
        """Restore the newest *valid* checkpoint into the structure of
        ``like``; returns ``(step, tree)`` or ``(None, None)`` when none
        exists.  A torn or corrupt newest checkpoint is skipped in favour
        of the next older valid one."""
        self.wait()
        with self._lock:
            for step in reversed(all_steps(self.path)):
                try:
                    return step, restore(self.path, step, like,
                                         device=device)
                except (CheckpointCorrupt, FileNotFoundError):
                    continue    # torn or vanished: fall back to older
            return None, None

    def load_latest(self):
        """Like :meth:`restore_latest` with no like-tree: returns ``(step,
        leaves, extra)`` via :func:`load`, or ``(None, None, None)``.  Same
        newest-valid fallback on corruption."""
        self.wait()
        with self._lock:
            return load_latest_valid(self.path)

    def peek_latest(self) -> Tuple[Optional[int], Optional[dict]]:
        """Manifest-only :func:`peek_extra` of the newest checkpoint,
        under the manager's lock (safe against a concurrent prune)."""
        self.wait()
        with self._lock:
            while True:
                step = latest_step(self.path)
                if step is None:
                    return None, None
                try:
                    return peek_extra(self.path, step)
                except FileNotFoundError:
                    continue

    def _prune(self):
        for s in all_steps(self.path)[:-self.keep]:
            shutil.rmtree(_step_dir(self.path, s), ignore_errors=True)
