"""The port's one-token decode step against the JAX package's, on the CPU.

For each of the ten architectures (SMOKE configs, float32), ``repro``'s
weights reach the port through ``params_from_numpy`` and ``repro``'s
prefill caches of the first L - 1 positions through
``caches_from_numpy``; the port's ``make_decode_step`` on position L - 1
(a token id, musicgen's four codebook ids, qwen2-vl's input embedding
with its three equal M-RoPE position streams) must give ``repro``'s
logits and every cache leaf ``repro`` returns (KV rings, Mamba conv and ssm, mLSTM C, n, m, sLSTM h, c, n, m)
within 1e-4 of the leaf's max |value|.  Also: the port's prefill +
decode equals its own full forward at 2e-3 (``tests/test_models.py:58``),
gemma's local ring decoding past three windows (``:92``), ``mlstm_step``
against ``repro``'s with extreme gates, and ``init_cache`` and
``init_kv_cache`` against ``repro``'s."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import xlstm as PX  # noqa: E402
from repro_torch.models.convert import (caches_from_numpy,  # noqa: E402
                                        caches_to_numpy, params_from_numpy)
from model_batches import batch_np  # noqa: E402

ARCHS = JC.list_archs()
B, L = 2, 40        # gemma's SMOKE window is 16: its local rings wrap


def _jax(batch, sl):
    return {k: jnp.asarray(v[:, sl], jnp.float32 if k == "embeds" else
                           jnp.int32) for k, v in batch.items()}


def _torch(batch, sl):
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, sl]))
            for k, v in batch.items()}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close_to_max(got, want, tol, name):
    """max |got - want| <= tol * max |want| (the leaf's scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if want.size else 0.0
    assert err <= tol * scale, (name, err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request):
    """One arch's weights, prompt, ``repro``'s prefill(L - 1) caches and
    ``repro``'s decode of token L - 1 from them."""
    arch = request.param
    jcfg, pcfg = JC.get_smoke(arch), PC.get_smoke(arch)
    params = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(11))
    batch = batch_np(jcfg, B, L, 12)
    pos = np.full((B,), L - 1, np.int32)
    _, jcaches = jax.jit(JM.make_prefill_step(jcfg, pad_to=L))(
        params, _jax(batch, slice(None, -1)))
    want_logits, want_caches = jax.jit(JM.make_decode_step(jcfg))(
        params, jcaches, _jax(batch, slice(-1, None)), jnp.asarray(pos))
    np_caches = jax.tree.map(np.asarray, jcaches)
    return dict(arch=arch, pcfg=pcfg, batch=batch, pos=pos,
                p_params=params_from_numpy(jax.tree.map(np.asarray, params)),
                np_caches=np_caches,
                want_logits=np.asarray(want_logits, np.float32),
                want_caches=jax.tree.map(np.asarray, want_caches))


def test_decode_matches_repro(decoded):
    d = decoded
    decode = PM.make_decode_step(d["pcfg"])
    caches = caches_from_numpy(d["np_caches"])
    before = {p: t.clone() for p, t in _leaves(caches)}
    logits, new = decode(PM.cast_params(d["pcfg"], d["p_params"]), caches,
                         _torch(d["batch"], slice(-1, None)),
                         torch.from_numpy(d["pos"]))
    cfg = d["pcfg"]
    head = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    assert tuple(logits.shape) == (B, 1, *head, cfg.vocab)
    _close_to_max(logits.numpy(), d["want_logits"], 1e-4, "logits")
    got = dict(_leaves(caches_to_numpy(new)))
    want = dict(_leaves(d["want_caches"]))
    assert got.keys() == want.keys()
    for path in want:
        _close_to_max(got[path], want[path], 1e-4, path)
    # the step is functional: the caches it was given are unchanged
    for p, t in _leaves(caches):
        assert torch.equal(t, before[p]), p


def test_decode_matches_own_forward(decoded):
    """Teacher forcing: the port's prefill(L - 1) + decode(token L - 1)
    == its full forward's last position (``tests/test_models.py:58``)."""
    d = decoded
    cfg, params = d["pcfg"], d["p_params"]
    full, _, _ = PM.forward(cfg, params, **_torch(d["batch"], slice(None)))
    _, caches = PM.make_prefill_step(cfg, pad_to=L)(
        params, _torch(d["batch"], slice(None, -1)))
    lg, _ = PM.make_decode_step(cfg)(PM.cast_params(cfg, params), caches,
                                     _torch(d["batch"], slice(-1, None)),
                                     torch.from_numpy(d["pos"]))
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_decode_beyond_window_uses_ring():
    """gemma's local layers decode three windows in (the ring wrapped
    twice) and agree with a fresh forward (``tests/test_models.py:92``),
    and with ``repro``'s decode at 1e-4."""
    jcfg, cfg = JC.get_smoke("gemma3-1b"), PC.get_smoke("gemma3-1b")
    jparams = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    n = cfg.window * 3
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (1, n)))
    _, caches = PM.make_prefill_step(cfg, pad_to=n)(
        params, {"tokens": toks[:, :n - 1]})
    pos = torch.full((1,), n - 1, dtype=torch.int32)
    lg, new = PM.make_decode_step(cfg)(params, caches,
                                       {"tokens": toks[:, n - 1:]}, pos)
    full, _, _ = PM.forward(cfg, params, tokens=toks)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    local = new["scan"]["s0"]["k"]
    assert local.shape[2] == cfg.window          # min(S, window) slots
    want, _ = JM.make_decode_step(jcfg)(
        jparams, jax.tree.map(jnp.asarray, caches_to_numpy(caches)),
        {"tokens": jnp.asarray(toks[:, n - 1:].numpy(), jnp.int32)},
        jnp.asarray(pos.numpy()))
    _close_to_max(lg.numpy(), np.asarray(want), 1e-4, "logits")


@pytest.mark.parametrize("gates", ["normal", "extreme"])
def test_mlstm_step_matches_repro(gates):
    rng = np.random.default_rng(7)
    Bq, H, Dh = 3, 2, 16
    q, k, v = (rng.standard_normal((Bq, H, Dh)).astype(np.float32)
               for _ in "qkv")
    C = rng.standard_normal((Bq, H, Dh, Dh)).astype(np.float32)
    n = rng.standard_normal((Bq, H, Dh)).astype(np.float32)
    m = rng.standard_normal((Bq, H)).astype(np.float32)
    if gates == "normal":
        i = rng.standard_normal((Bq, H)).astype(np.float32)
        f = rng.standard_normal((Bq, H)).astype(np.float32) + 2
    else:       # saturated forget gates, vanishing and huge input gates
        i = np.array([[-200.0, 60.0], [-1e4, 0.0], [80.0, -90.0]], np.float32)
        f = np.array([[100.0, -100.0], [40.0, -40.0], [1e4, -1e4]],
                     np.float32)
        m[0, 0] = 0.0                            # a fresh slot's m
    jh, (jC, jn, jm) = JX.mlstm_step(*map(jnp.asarray, (q, k, v, i, f)),
                                     tuple(map(jnp.asarray, (C, n, m))))
    ph, (pC, pn, pm) = PX.mlstm_step(*map(torch.from_numpy, (q, k, v, i, f)),
                                     tuple(map(torch.from_numpy, (C, n, m))))
    for name, g, w in (("h", ph, jh), ("C", pC, jC), ("n", pn, jn),
                       ("m", pm, jm)):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    zC, zn, zm = PX.init_mlstm_state(2, 3, 4)
    jz = JX.init_mlstm_state(2, 3, 4)
    for g, w in zip((zC, zn, zm), jz):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_repro_specs(arch, dtype):
    jcfg = dataclasses.replace(JC.get_smoke(arch), compute_dtype=dtype)
    pcfg = dataclasses.replace(PC.get_smoke(arch), compute_dtype=dtype)
    want = dict(_leaves(JM.init_cache(jcfg, 3, 20)))
    got = dict(_leaves(PM.init_cache(pcfg, 3, 20, device="cpu")))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        assert not g.any(), path


@pytest.mark.parametrize("S,window", [(20, None), (20, 8), (6, 8)])
def test_init_kv_cache_matches_repro(S, window):
    from repro.models import attention as JA
    from repro_torch.models import attention as PA
    want = JA.init_kv_cache(2, S, 3, 4, jnp.bfloat16, window=window)
    got = PA.init_kv_cache(2, S, 3, 4, torch.bfloat16, window=window,
                            device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        assert not g.any()
    assert got.k.data_ptr() != got.v.data_ptr()   # two buffers, not one


@pytest.mark.parametrize("which", ["init_cache", "init_kv_cache"])
def test_cache_allocators_default_to_cuda(which):
    """Both allocators build on the card unless asked for the CPU, and
    raise without CUDA rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models import attention as PA
    with pytest.raises(RuntimeError, match="CUDA"):
        if which == "init_cache":
            PM.init_cache(PC.get_smoke("gemma3-1b"), 2, 8)
        else:
            PA.init_kv_cache(2, 8, 3, 4, torch.float32)
