"""The port's model-plane layers against the JAX package's, on the CPU.

Each function gets the same numpy inputs (from a seed) in both packages:
``rms_norm`` (plain and gemma's plus-one), ``apply_rope`` (halves, not
interleaved pairs), ``swiglu`` and ``mlp_plain`` (tanh-GELU and SiLU),
``causal_conv1d`` (with and without a carried state), ``qkv_project``
with QK-norm, ``attend_causal`` chunked and unchunked, with and without a
window, and ``cache_from_prefill`` rolled (a window shorter than the
prompt) and padded (a capacity longer than it).  float32, at 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(*key):
    return np.random.default_rng(list(key))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 5, 4, 16)])
def test_rms_norm(plus_one, shape):
    rng = _rng(1, len(shape), plus_one)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    _close(PL.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6,
                       plus_one=plus_one),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6,
                       plus_one=plus_one))


def test_rms_norm_keeps_bf16_and_computes_in_f32():
    x = _rng(2).standard_normal((4, 32)).astype(np.float32)
    g = np.ones(32, np.float32)
    got = PL.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    want = JL.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_rotates_halves(theta):
    rng = _rng(3, int(theta))
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    _close(PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_swiglu(act):
    rng = _rng(4, len(act))
    x, wg, wu = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 5, 16), (16, 24), (16, 24)))
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    args = (x, wg, wu, wd)
    _close(PL.swiglu(*map(torch.from_numpy, args), act=act),
           JL.swiglu(*map(jnp.asarray, args), act=act))


@pytest.mark.parametrize("act", ["gelu", "relu2", "relu"])
def test_mlp_plain(act):
    rng = _rng(5, len(act))
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wu = rng.standard_normal((16, 24)).astype(np.float32)
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    _close(PL.mlp_plain(*map(torch.from_numpy, (x, wu, wd)), act=act),
           JL.mlp_plain(*map(jnp.asarray, (x, wu, wd)), act=act), rtol=1e-5,
           atol=3e-5)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    want = torch.nn.functional.gelu(x, approximate="tanh")
    torch.testing.assert_close(PL._gelu(x), want, rtol=0, atol=0)
    assert (PL._gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    rng = _rng(6, with_state)
    x = rng.standard_normal((2, 11, 8)).astype(np.float32)
    kern = rng.standard_normal((4, 8)).astype(np.float32)
    st = rng.standard_normal((2, 3, 8)).astype(np.float32) if with_state else None
    y, ns = PL.causal_conv1d(torch.from_numpy(x), torch.from_numpy(kern),
                             None if st is None else torch.from_numpy(st))
    yj, nsj = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(kern),
                               None if st is None else jnp.asarray(st))
    _close(y, yj)
    _close(ns, nsj)


def _attn_params(rng, D, H, KV, dh, qk_norm):
    p = {"wq": rng.standard_normal((D, H * dh)) / np.sqrt(D),
         "wk": rng.standard_normal((D, KV * dh)) / np.sqrt(D),
         "wv": rng.standard_normal((D, KV * dh)) / np.sqrt(D)}
    if qk_norm:
        p["q_norm"] = 1 + 0.1 * rng.standard_normal(dh)
        p["k_norm"] = 1 + 0.1 * rng.standard_normal(dh)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_project(qk_norm):
    rng = _rng(7, qk_norm)
    p = _attn_params(rng, 32, 4, 2, 8, qk_norm)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, d_head=8, qk_norm_eps=1e-6 if qk_norm else None)
    got = PA.qkv_project(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()}, **kw)
    want = JA.qkv_project(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("L,chunk", [(48, 1024), (48, 16), (50, 16)])
@pytest.mark.parametrize("window", [None, 7])
def test_attend_causal(L, chunk, window):
    """chunk 16 divides 48 (three q chunks); 50 is not a multiple, so
    both packages attend unchunked there."""
    rng = _rng(8, L, chunk, window or 0)
    q = rng.standard_normal((2, L, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, L, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, L, 2, 8)).astype(np.float32)
    got = PA.attend_causal(*map(torch.from_numpy, (q, k, v)), window=window,
                           chunk=chunk)
    want = JA.attend_causal(*map(jnp.asarray, (q, k, v)), window=window,
                            chunk=chunk)
    _close(got, want)


def test_attend_causal_softcap_and_offset():
    rng = _rng(9)
    q = rng.standard_normal((1, 8, 2, 8)).astype(np.float32) * 3
    k = rng.standard_normal((1, 20, 2, 8)).astype(np.float32) * 3
    v = rng.standard_normal((1, 20, 2, 8)).astype(np.float32)
    kw = dict(softcap=5.0, q_offset=12, window=6)
    _close(PA.attend_causal(*map(torch.from_numpy, (q, k, v)), **kw),
           JA.attend_causal(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("L,window,pad_to", [
    (37, 16, None),     # rolled: the last 16 positions, p in slot p % 16
    (32, 16, None),     # rolled by 0
    (12, 16, None),     # padded to the window
    (12, None, 20),     # global, padded to the decode capacity
    (20, None, None),   # global, exactly the prompt
])
def test_cache_from_prefill(L, window, pad_to):
    rng = _rng(10, L, window or 0, pad_to or 0)
    k = rng.standard_normal((2, L, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, L, 2, 8)).astype(np.float32)
    got = PA.cache_from_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                window=window, pad_to=pad_to)
    want = JA.cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                 window=window, pad_to=pad_to)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
