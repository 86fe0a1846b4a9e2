"""The gradients of the port's three model kernels, on the CPU.

Each kernel's wrapper goes through an ``autograd.Function`` when an input
requires grad: forward the kernel (here, on the CPU, its plain version),
backward the plain version's gradient (attention, mLSTM) or the JAX
package's adjoint recurrence (the selective scan).  Held here: attention
and mLSTM gradients through their Function bitwise equal to autograd
through the plain version, the scan's adjoint within 1e-5 of autograd
through the plain loop (chunked, with and without a chunk that divides
L), the sLSTM loop's grad path equal to its in-place path, ``remat``
gradients equal to the plain forward's, and the guard that makes a train
step raise when a parameter gets no gradient (a graph cut)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ops import (MLSTMChunkwiseFn,  # noqa: E402
                                                 mlstm_chunkwise)
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise_ref  # noqa: E402
from repro_torch.kernels.selective_scan.ops import (  # noqa: E402
    SelectiveScanFn, chunk_len, selective_scan)
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402


def _leafs(*shapes, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).requires_grad_()
            for s in shapes]


def _grads(out, ins, up):
    return torch.autograd.grad(out, ins, up)


def _reaches(t, name, depth=4):
    """Whether ``name``'s backward node is within ``depth`` steps of
    ``t``'s ``grad_fn`` (the reshape of an output adds nodes)."""
    nodes = [t.grad_fn]
    for _ in range(depth):
        if any(name in type(n).__name__ for n in nodes):
            return True
        nodes = [f for n in nodes for f, _ in n.next_functions if f]
    return False


def _equal(a, b):
    for x, y in zip(a, b):
        assert x is not None and y is not None
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_is_the_plain_gradient(window, dtype):
    B, L, H, KV, Dh = 2, 13, 4, 2, 8
    q, k, v = _leafs((B, L, H, Dh), (B, L, KV, Dh), (B, L, KV, Dh),
                     dtype=dtype)
    up = torch.randn(B, L, H * Dh).to(dtype)
    out = fa_ops.flash_attention_blhd(q, k, v, window=window)
    assert _reaches(out, "FlashAttentionFn")
    plain = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), window=window
                          ).transpose(1, 2).to(dtype).reshape(B, L, H * Dh)
    assert torch.equal(out, plain)
    _equal(_grads(out, (q, k, v), up), _grads(plain, (q, k, v), up))


def test_attention_without_grad_saves_nothing():
    q, k, v = (t.detach() for t in _leafs((1, 6, 2, 4), (1, 6, 1, 4),
                                          (1, 6, 1, 4)))
    out = fa_ops.flash_attention_blhd(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        q.requires_grad_()
        assert fa_ops.flash_attention_blhd(q, k, v).grad_fn is None


def test_attention_function_on_the_cpu_refuses_the_kernel():
    q, k, v = _leafs((1, 6, 2, 4), (1, 6, 1, 4), (1, 6, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_blhd(q, k, v, use_kernel=True)


def _scan_inputs(B, L, Di, S, seed):
    rng = np.random.default_rng(seed)
    a = np.exp(-np.abs(rng.standard_normal((B, L, Di, S))))
    return [torch.tensor(x, dtype=torch.float32, requires_grad=True)
            for x in (a, rng.standard_normal((B, L, Di, S)),
                      rng.standard_normal((B, L, S)),
                      rng.standard_normal((B, Di, S)))]


@pytest.mark.parametrize("L,chunk", [(24, 8), (24, 16), (24, None), (1, 8)])
def test_scan_adjoint_matches_autograd_through_the_loop(L, chunk):
    """The Function against autograd through ``selective_scan_ref``'s
    loop, with upstream gradients on y and on the final state; chunk 16
    does not divide 24, so the whole sequence is one chunk, as in
    ``repro``."""
    B, Di, S = 2, 6, 4
    ins = _scan_inputs(B, L, Di, S, L + (chunk or 0))
    gy, gh = torch.randn(B, L, Di), torch.randn(B, Di, S)
    y, h = selective_scan(*ins, chunk=chunk)
    assert _reaches(y, "SelectiveScanFn")
    y0, h0 = selective_scan_ref(*ins)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    got = torch.autograd.grad((y, h), ins, (gy, gh))
    want = torch.autograd.grad((y0, h0), ins, (gy, gh))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_scan_chunk_rule():
    assert [chunk_len(c, 24) for c in (8, 16, 24, 64, None)] == [
        8, 24, 24, 24, 24]


def test_scan_without_grad_is_one_pass():
    ins = [t.detach() for t in _scan_inputs(1, 10, 3, 2, 0)]
    y, h = selective_scan(*ins, chunk=4)
    y0, h0 = selective_scan_ref(*ins)
    assert y.grad_fn is None and torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.parametrize("use_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_function_is_the_plain_gradient(use_state, dtype):
    """h alone read downstream (training), or h and the final (C, n, m)."""
    B, H, L, Dh = 2, 2, 20, 8
    q, k, v = _leafs(*[(B, H, L, Dh)] * 3, dtype=dtype, seed=1)
    i_raw, f_raw = _leafs((B, H, L), (B, H, L), seed=2)
    ins = (q, k, v, i_raw, f_raw)
    h, (C, n, m) = mlstm_chunkwise(*ins, chunk=8)
    assert _reaches(h, "MLSTMChunkwiseFn")
    h0, (C0, n0, m0) = mlstm_chunkwise_ref(*ins, None, 8)
    for x, y in zip((h, C, n, m), (h0, C0, n0, m0)):
        assert torch.equal(x, y)
    g = torch.Generator().manual_seed(3)
    ups = [torch.randn(t.shape, generator=g) for t in (h, C, n, m)]
    k_out = 4 if use_state else 1
    _equal(torch.autograd.grad((h, C, n, m)[:k_out], ins, ups[:k_out]),
           torch.autograd.grad((h0, C0, n0, m0)[:k_out], ins, ups[:k_out]))


def test_mlstm_function_takes_no_state():
    ins = _leafs((1, 1, 8, 4), (1, 1, 8, 4), (1, 1, 8, 4), (1, 1, 8),
                 (1, 1, 8))
    out = MLSTMChunkwiseFn.apply(*ins, 4, None)
    assert len(out) == 4
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_chunkwise(*ins, chunk=4, use_kernel=True)


def test_slstm_grad_path_equals_the_in_place_path():
    B, L, D, H = 2, 9, 16, 4
    g = torch.Generator().manual_seed(5)
    gates = torch.randn(B, L, 4 * D, generator=g)
    r = torch.randn(4, H, D // H, D // H, generator=g) * 0.3
    state = xlstm.init_slstm_state(B, D)
    with torch.no_grad():
        hs0, st0 = xlstm.slstm_scan(gates, r, state, H)
    gates.requires_grad_()
    hs, st = xlstm.slstm_scan(gates, r, state, H)
    assert hs.grad_fn is not None
    assert torch.equal(hs, hs0)
    for a, b in zip(st, st0):
        assert torch.equal(a, b)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _smoke(arch, **kw):
    cfg = dataclasses.replace(get_smoke(arch), **kw)
    params = init_params(PM.param_specs(cfg),
                         torch.Generator().manual_seed(4), "cpu")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return cfg, params, batch


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-v0.1-52b"])
def test_remat_gradients_equal_the_plain_forward(arch):
    cfg, params, batch = _smoke(arch, remat=False)
    loss, grads = PM.make_grads_fn(cfg)(params, batch)
    loss_r, grads_r = PM.make_grads_fn(
        dataclasses.replace(cfg, remat=True))(params, batch)
    assert torch.equal(loss, loss_r)
    flat, flat_r = dict(_flat(grads)), dict(_flat(grads_r))
    assert flat.keys() == flat_r.keys()
    for p, a in flat.items():
        assert torch.equal(a, flat_r[p]), p


def test_a_cut_graph_raises(monkeypatch):
    """A kernel launched outside its Function returns a tensor with no
    ``grad_fn``: the attention weights then get no gradient, and the
    train step must say so instead of training the rest."""
    cfg, params, batch = _smoke("gemma3-1b")
    real = attn_mod.flash_attention_blhd
    monkeypatch.setattr(attn_mod, "flash_attention_blhd",
                        lambda *a, **kw: real(*a, **kw).detach())
    with pytest.raises(RuntimeError, match="graph is cut"):
        PM.make_grads_fn(cfg)(params, batch)
