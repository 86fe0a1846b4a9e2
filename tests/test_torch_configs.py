"""The port's architecture registry helpers and ``input_specs`` against the
JAX package's, on the CPU, for all ten architectures.

``get_shape``, ``SHAPES`` and ``cells`` must be ``repro``'s; so must each
published configuration's ``has_mixer`` (every mixer kind),
``long_context_ok``, ``pure_recurrent`` and ``n_active_params``.  For
every cell of ``cells(arch)``, ``input_specs`` must give the tree of
``repro``'s ``input_specs`` (token ids, codebook frames or embeddings,
labels, decode caches and positions) with the same shapes and dtypes, as
tensors on the meta device: no storage is allocated."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import config as JCfg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import config as PCfg  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

ARCHS = JC.list_archs()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_shapes_match_repro():
    assert PCfg.SHAPES.keys() == JCfg.SHAPES.keys()
    for name, want in JCfg.SHAPES.items():
        got = PC.get_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.is_train == want.is_train
    with pytest.raises(KeyError):
        PC.get_shape("no-such-shape")


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_helpers_match_repro(arch):
    assert PC.cells(arch) == JC.cells(arch)
    for get in ("get_config", "get_smoke"):
        jcfg, pcfg = getattr(JC, get)(arch), getattr(PC, get)(arch)
        for kind in (PCfg.ATTN, PCfg.ATTN_LOCAL, PCfg.MAMBA, PCfg.MLSTM,
                     PCfg.SLSTM):
            assert pcfg.has_mixer(kind) == jcfg.has_mixer(kind), kind
        assert pcfg.long_context_ok == jcfg.long_context_ok
        assert pcfg.pure_recurrent == jcfg.pure_recurrent
        assert pcfg.n_active_params() == jcfg.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_repro_on_the_meta_device(arch):
    pcfg, jcfg = PC.get_config(arch), JC.get_config(arch)
    for cell in PC.cells(arch):
        want = dict(_leaves(JM.input_specs(jcfg, JC.get_shape(cell))))
        got = dict(_leaves(PM.input_specs(pcfg, PC.get_shape(cell))))
        assert got.keys() == want.keys(), cell
        for path, w in want.items():
            g = got[path]
            assert g.device.type == "meta", (cell, path)
            assert tuple(g.shape) == tuple(w.shape), (cell, path)
            assert str(g.dtype).removeprefix("torch.") == \
                np.dtype(w.dtype).name, (cell, path)
    batch = PM.input_specs(pcfg, PC.get_shape("prefill_32k"))["batch"]
    key = "embeds" if pcfg.embed_inputs else "tokens"
    assert list(batch) == [key]


def test_abstract_cache_matches_init_cache():
    cfg = PC.get_smoke("jamba-v0.1-52b")
    meta = dict(_leaves(PM.abstract_cache(cfg, 3, 20)))
    real = dict(_leaves(PM.init_cache(cfg, 3, 20, device="cpu")))
    want = dict(_leaves(jax.tree.map(
        lambda s: (tuple(s.shape), np.dtype(s.dtype).name),
        JM.abstract_cache(JC.get_smoke("jamba-v0.1-52b"), 3, 20))))
    assert meta.keys() == real.keys() == want.keys()
    for path, t in meta.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (real[path].shape, real[path].dtype)
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
            want[path]
