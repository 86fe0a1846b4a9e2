"""The slice as a whole: the port's ``make_prefill_step`` against the JAX
package's, on the CPU, for all ten architectures (SMOKE sizes).

The parameters are drawn by ``repro.models.init_params`` and handed to
the port as numpy (``params_from_numpy``), so both packages run the same
weights on the same prompt (token ids, musicgen's four codebook ids a
position, qwen2-vl's input embeddings); the last position's logits
(musicgen's per codebook) and every cache leaf (local rings rolled,
global caches, Mamba conv and ssm states, the mLSTM (conv, C, n, m) and
sLSTM (conv, h, c, n, m) states) must match at 1e-4 in float32.  Also: ``param_specs`` and ``count_params`` of
the full published configurations equal ``repro``'s, ``cast_params``
gives every leaf ``repro``'s dtype in bf16 (stacked vectors cast, prefix
vectors kept float32), the registry and the configurations equal
``repro``'s, and the mLSTM block continues from its own prefill cache
as ``repro``'s does."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (caches_to_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.params import init_params  # noqa: E402
from model_batches import batch_np  # noqa: E402

ARCHS = JC.list_archs()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_matches_repro(arch):
    jcfg, pcfg = JC.get_smoke(arch), PC.get_smoke(arch)
    params = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(1))
    B, L = 2, 48       # gemma's window is 16: its local caches roll
    batch = batch_np(jcfg, B, L, 2)
    want_logits, want_caches = jax.jit(JM.make_prefill_step(jcfg))(
        params, {k: jnp.asarray(v, jnp.float32 if k == "embeds" else
                                jnp.int32) for k, v in batch.items()})
    got_logits, got_caches = PM.make_prefill_step(pcfg)(
        params_from_numpy(jax.tree.map(np.asarray, params)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    head = (pcfg.n_codebooks,) if pcfg.n_codebooks > 1 else ()
    assert tuple(got_logits.shape) == (B, *head, jcfg.vocab)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    got = dict(_leaves(caches_to_numpy(got_caches)))
    want = dict(_leaves(jax.tree.map(np.asarray, want_caches)))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))
    specs = PM.cache_specs(pcfg, B, L)
    assert {p: s.shape for p, s in specs.items()} == {
        p: got[p].shape for p in got}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_param_specs_and_counts_match_repro(arch, which):
    get = "get_config" if which == "config" else "get_smoke"
    jcfg, pcfg = getattr(JC, get)(arch), getattr(PC, get)(arch)
    js, ps = JM.param_specs(jcfg), PM.param_specs(pcfg)
    assert js.keys() == ps.keys()
    for path, s in js.items():
        t = ps[path]
        assert (t.shape, t.axes, t.init, t.dtype, t.scale) == (
            s.shape, s.axes, s.init, s.dtype, s.scale), path
    for kw in ({}, {"active_only": True}, {"exclude_embed": True}):
        assert PM.count_params(pcfg, **kw) == JM.count_params(jcfg, **kw)
    assert pcfg.n_params() == jcfg.n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_dtypes_in_bf16(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), compute_dtype="bfloat16")
    pcfg = dataclasses.replace(PC.get_smoke(arch), compute_dtype="bfloat16")
    params = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(0))
    want = dict(_leaves(jax.tree.map(lambda a: str(a.dtype),
                                     JM.cast_params(jcfg, params))))
    got = dict(_leaves(PM.cast_params(
        pcfg, params_from_numpy(jax.tree.map(np.asarray, params)))))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert str(t.dtype).removeprefix("torch.") == want[path], path
    stacked = [p for p in got if p[0] == "scan" and got[p].dim() == 2]
    assert stacked and all(got[p].dtype == torch.bfloat16 for p in stacked)
    one_d = [p for p in got if got[p].dim() == 1]
    assert one_d and all(got[p].dtype == torch.float32 for p in one_d)


def test_init_params_draws_every_leaf_to_spec():
    cfg = PC.get_smoke("jamba-v0.1-52b")
    specs = PM.param_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    tree = PM.cast_params(cfg, init_params(specs, gen, "cpu"))
    leaves = dict(_leaves(tree))
    for path, s in specs.items():
        assert tuple(leaves[path].shape) == s.shape, path
        assert torch.isfinite(leaves[path]).all(), path
    a = leaves[("scan", "s0", "mixer", "A_log")][0]
    np.testing.assert_allclose(a.exp().numpy(),
                               np.tile(np.arange(1, 9), (a.shape[0], 1)),
                               rtol=1e-6)
    # a unit normal truncated at +-3 has std 0.986; fan-in is d_model
    std = leaves[("scan", "s0", "mixer", "in_proj")].std().item()
    assert abs(std * np.sqrt(cfg.d_model) - 0.986) < 0.02


def test_registry_and_configs_match_repro():
    for arch in PC.list_archs():
        for get in ("get_config", "get_smoke"):
            assert dataclasses.asdict(getattr(PC, get)(arch)) == \
                dataclasses.asdict(getattr(JC, get)(arch))
    assert PC.list_archs() == JC.list_archs() == ARCHS and len(ARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        PC.get_config("no-such-arch")


def test_mlstm_decode_step_raises_until_its_slice():
    """A prefill's mLSTM cache continues: ``mlstm_block`` decodes one
    token from its own prefill cache through ``mlstm_step`` (it raised
    until the decode slice) and equals ``repro``'s block on that cache."""
    from repro.models import xlstm as JX
    from repro_torch.models import xlstm
    jcfg = JC.get_smoke("xlstm-1.3b")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(3))
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      params["scan"]["s1"]["mixer"])
    p = params_from_numpy(jp)
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    _, cache = xlstm.mlstm_block(cfg, p, torch.from_numpy(x[:, :4]),
                                 collect=True)
    assert {p[2] for p in PM.cache_specs(cfg, 1, 4) if p[1] == "s1"} == \
        set(cache)
    y, new = xlstm.mlstm_block(cfg, p, torch.from_numpy(x[:, 4:]), cache)
    jc = jax.tree.map(jnp.asarray, caches_to_numpy(cache))
    wy, wnew = JX.mlstm_block(jcfg, jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(x[:, 4:]), jc)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-4,
                               atol=1e-4)
    assert set(new) == set(wnew)
    for k in wnew:
        np.testing.assert_allclose(caches_to_numpy(new)[k],
                                   np.asarray(wnew[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
