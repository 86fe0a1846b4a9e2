"""The port's flash attention (its plain version, the CPU path and the
oracle the CUDA kernel is held to on the card) against the JAX
package's ``attention_ref`` and its Pallas ``flash_attention`` in
interpret mode, at the sweep of ``tests/test_kernels.py``: 2e-5 in
float32 and 2e-2 in bf16, as there; the wrapper in the model plane's
(B, L, H, Dh) layout, given transposed views, returns the plain version
cast to q's dtype.  Also an odd length (no multiple of any block), the
wrapper against ``attend_causal``, and the ``ValueError`` for what
neither the kernel nor its plain version computes (a logit soft cap, a
query offset).  Two things behind the bf16 CUDA kernel's design, which
the card alone can run: why it feeds the probabilities to the bf16
tensor cores as P_hi + P_lo (an emulation in plain torch), and which
inputs its TMA reads in place and which the wrapper copies first."""
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
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    reads_in_place, tma_operand)
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


def _over_one_ulp(got, want):
    """Elements of bf16 ``got`` farther from bf16 ``want`` than one bf16
    unit in the last place (2^-7 |want| + 1e-5: chip_smoke.py's gate)."""
    g, w = got.float(), want.float()
    return int(((g - w).abs() > 2 ** -7 * w.abs() + 1e-5).sum())


def test_split_probabilities_hold_the_one_ulp_gate():
    """The plain version keeps the probabilities P in float32, as the
    Pallas body does.  A tensor-core P.V takes bf16 P: rounding P to bf16
    moves ~10 % of the outputs past one bf16 unit, while P_hi = bf16(P)
    and P_lo = bf16(P - P_hi), two products into one float32 sum, move
    none (one head, L 512, Dh 64, N(0, 1) bf16 q, k, v; P.V in float64
    from the chosen P, divided by the float32 P's row sum, rounded to
    bf16 as the kernel's output is)."""
    rng = np.random.default_rng(19)
    L, Dh = 512, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((L, Dh)).astype(
        np.float32)).bfloat16().float() for _ in range(3))
    s = (q @ k.T) * Dh ** -0.5
    s = s.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1),
                      float("-inf"))
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    row_sum = p.double().sum(-1, keepdim=True)

    def out(*parts):
        return (sum(x.double() @ v.double() for x in parts) / row_sum
                ).to(torch.bfloat16)

    want = out(p)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    assert _over_one_ulp(out(p_hi), want) > want.numel() // 20
    assert _over_one_ulp(out(p_hi, p_lo), want) == 0


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _misaligned(shape):
    """A (B, L, heads, Dh) view whose base is 2 bytes off 16."""
    n = int(np.prod(shape))
    return _bf16(n + 1)[1:].view(shape)


@pytest.mark.parametrize("make,in_place", [
    (lambda: _bf16((2, 64, 4, 256)), True),        # the model's layout
    (lambda: _bf16((2, 4, 64, 256)).transpose(1, 2), True),   # (B, H, L, Dh)
    (lambda: _bf16((2, 64, 4, 24)), True),         # 48-byte head stride
    (lambda: _bf16((1, 64, 1, 128)), True),        # one kv head, one batch
    (lambda: _bf16((2, 64, 6, 128))[:, :, 4:5], True),   # a slice of qkv
    (lambda: _bf16((2, 64, 4, 20)), False),        # 40-byte head stride
    (lambda: _bf16((2, 4, 64, 77)).transpose(1, 2), False),   # odd Dh
    (lambda: _misaligned((2, 64, 4, 64)), False),  # base off 16 bytes
    (lambda: _bf16((2, 64, 32, 4)).transpose(2, 3), False),   # Dh strided
    (lambda: _bf16((2, 64, 1, 128)).expand(2, 64, 4, 128), False),  # overlap
], ids=["model", "transposed", "dh24", "one_head", "qkv_slice", "dh20",
        "dh77", "misaligned", "dh_strided", "broadcast"])
def test_reads_in_place(make, in_place):
    """TMA's rules: a contiguous head dim, a 16-byte aligned base, and the
    outer dims of size > 1, by stride, 16-byte multiples that do not
    overlap."""
    assert reads_in_place(make()) is in_place


@pytest.mark.parametrize("shape,transpose", [((2, 33, 3, 20), False),
                                             ((1, 3, 17, 77), True),
                                             ((2, 9, 2, 5), False)])
def test_tma_operand_pads_what_it_cannot_read_in_place(shape, transpose):
    t = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32)).bfloat16()
    t = t.transpose(1, 2) if transpose else t
    got = tma_operand(t)
    assert not reads_in_place(t) and reads_in_place(got)
    assert got.shape == t.shape and torch.equal(got, t)
    assert got.stride(2) % 8 == 0 and got.stride(2) >= t.shape[3]
    fine = _bf16((2, 64, 4, 256))
    assert tma_operand(fine) is fine
