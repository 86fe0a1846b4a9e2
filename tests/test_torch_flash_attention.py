"""The port's flash attention (its plain version, the CPU path and the
oracle the CUDA kernel is held to on the card) against the JAX
package's ``attention_ref`` and its Pallas ``flash_attention`` in
interpret mode, at the sweep of ``tests/test_kernels.py``: 2e-5 in
float32 and 2e-2 in bf16, as there; the wrapper in the model plane's
(B, L, H, Dh) layout, given transposed views, returns the plain version
cast to q's dtype.  Also an odd length (no multiple of any block), the
wrapper against ``attend_causal``, and the ``ValueError`` for what
neither the kernel nor its plain version computes (a logit soft cap, a
query offset)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro.models.attention import attend_causal as j_attend  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_blhd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

SWEEP = [(1, 2, 2, 128, 64, None, 64), (2, 4, 2, 256, 128, None, 128),
         (1, 4, 1, 256, 64, 64, 64), (2, 2, 2, 128, 32, 32, 64),
         (1, 8, 4, 128, 64, None, 32)]


def _qkv(seed, B, H, KV, L, Dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, L, Dh)).astype(np.float32),
            rng.standard_normal((B, KV, L, Dh)).astype(np.float32),
            rng.standard_normal((B, KV, L, Dh)).astype(np.float32))


def _wrapped(q, k, v, window):
    """The wrapper on (B, H, L, Dh) tensors, through transposed views;
    returns (B, H, L, Dh)."""
    B, H, L, Dh = q.shape
    out = flash_attention_blhd(*(t.transpose(1, 2) for t in (q, k, v)),
                               window=window)
    return out.reshape(B, L, H, Dh).transpose(1, 2)


def _bf16_np(x):
    """x rounded to bf16 (as both packages round it), held as float32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("B,H,KV,L,Dh,win,blk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_repro_ref_and_pallas(B, H, KV, L, Dh, win, blk, dtype):
    q, k, v = _qkv(L + Dh + H, B, H, KV, L, Dh)
    if dtype == "bfloat16":
        q, k, v = map(_bf16_np, (q, k, v))
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    got = attention_ref(*args, window=win)
    wrapped = _wrapped(*args, win)
    assert wrapped.dtype == tdt and tuple(wrapped.shape) == q.shape
    assert torch.equal(wrapped, got.to(tdt))
    got = got.numpy()
    want = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=True, window=win))
    jdt = getattr(jnp, dtype)
    pallas = np.asarray(j_flash(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                causal=True, window=win, blk_q=blk, blk_k=blk,
                                interpret=True), np.float32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("L,win", [(77, None), (77, 10), (1, None)])
def test_odd_lengths(L, win):
    """No Pallas block divides 77, so only the JAX ref stands beside it."""
    q, k, v = _qkv(L, 2, 4, 2, L, 24)
    got = _wrapped(*map(torch.from_numpy, (q, k, v)), win)
    want = j_attention_ref(*map(jnp.asarray, (q, k, v)), window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("win", [None, 5])
def test_blhd_wrapper_matches_attend_causal(win):
    """The model plane's layout: (B, L, H, Dh) in, (B, L, H*Dh) out,
    against ``repro``'s jnp ``attend_causal`` at the SMOKE widths."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 1, 16)).astype(np.float32)
    got = flash_attention_blhd(*map(torch.from_numpy, (q, k, v)), window=win)
    want = j_attend(*map(jnp.asarray, (q, k, v)), window=win)
    assert tuple(got.shape) == (2, 40, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_port_ref_is_the_jax_ref():
    q, k, v = _qkv(3, 1, 4, 2, 33, 8)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), window=9,
                        scale=0.3)
    want = j_attention_ref(*map(jnp.asarray, (q, k, v)), window=9, scale=0.3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arg,match", [({"softcap": 30.0}, "soft cap"),
                                       ({"q_offset": 3}, "q_offset")])
@pytest.mark.parametrize("use_kernel", [None, False])
def test_softcap_and_offset_raise(arg, match, use_kernel):
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match=match):
        flash_attention_blhd(q, q, q, use_kernel=use_kernel, **arg)


def test_kernel_refuses_cpu_tensors():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_blhd(q, q, q, use_kernel=True)
