"""The port's xLSTM layers against the JAX package's, on the CPU.

The chunkwise mLSTM (its plain version: the CPU path, and the oracle the
CUDA kernel is held to on the card) against ``repro``'s chunkwise form,
from the zero state and from a carried one, against ``repro``'s Pallas
kernel in interpret mode and against ``repro``'s float64 sequential
``mlstm_ref``, on the sweep of ``tests/test_kernels.py`` at 3e-4, as
there.  The port's float64 oracle against ``repro``'s.  Then
``_headwise_norm``, ``mlstm_block`` and ``slstm_block`` with one SMOKE
layer's weights (``params_from_numpy``) at 1e-5 in float32, the sLSTM
continuing from a cache too; ``log_sigmoid`` at large |x|; and a float64
model, which the casts to the wider of float32 and the input's type run
in float64 throughout.

The CUDA kernel's precision design, emulated in plain torch: its bf16
pieces (``kernel.bf16_pieces``), the chunkwise form with each product
summed over the piece pairs the kernel runs, against the float64 oracle,
and the wrapper's TMA operand rules."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_smoke  # noqa: E402
from repro.kernels.mlstm_chunk.ops import mlstm_pallas  # noqa: E402
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_oracle  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.configs import get_smoke as p_smoke  # noqa: E402
from repro_torch.kernels.mlstm_chunk.kernel import (  # noqa: E402
    bf16_pieces, input_layout, reads_in_place, tma_operand)
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (NEG,  # noqa: E402
                                                 init_mlstm_state, mlstm_ref)
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import xlstm as PX  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SWEEP = [(1, 2, 32, 16, 8), (2, 2, 64, 32, 16), (1, 4, 128, 64, 32),
         (1, 1, 64, 128, 64)]                      # tests/test_kernels.py:119
TOL = dict(rtol=3e-4, atol=3e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "xlstm-1.3b"


def _cell_inputs(seed, B, H, L, Dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32)
               for _ in "qkv")
    i = rng.standard_normal((B, H, L)).astype(np.float32)
    f = (rng.standard_normal((B, H, L)) + 2).astype(np.float32)
    return q, k, v, i, f


def _state(seed, B, H, Dh):
    """A carried state as a prefill leaves it: C and n from a short
    sequence, m its running stabiliser."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((B, H, Dh, Dh)) * 0.5).astype(np.float32)
    n = (rng.standard_normal((B, H, Dh)) * 0.5).astype(np.float32)
    m = rng.standard_normal((B, H)).astype(np.float32)
    return C, n, m


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().double().numpy(),
                               np.asarray(want, np.float64), **tol)


@pytest.mark.parametrize("B,H,L,Dh,ck", SWEEP)
@pytest.mark.parametrize("start", ["zero", "carried"])
def test_plain_chunkwise_matches_repro(B, H, L, Dh, ck, start):
    """Against ``repro``'s chunkwise form and its float64 oracle; from the
    zero state also against its Pallas kernel (interpret mode), which
    starts there."""
    args = _cell_inputs(L + Dh, B, H, L, Dh)
    st = (_state(B + Dh, B, H, Dh) if start == "carried" else
          tuple(t.numpy() for t in init_mlstm_state(B, H, Dh)))
    h, (C, n, m) = mlstm_chunkwise(*map(torch.from_numpy, args),
                                   tuple(map(torch.from_numpy, st)), chunk=ck)
    wants = [JX.mlstm_chunkwise(*map(jnp.asarray, args),
                                tuple(map(jnp.asarray, st)), ck),
             j_oracle(*args, *st)]
    if start == "zero":
        wants.append(mlstm_pallas(*map(jnp.asarray, args), chunk=ck,
                                  interpret=True))
    for wh, (wC, wn, wm) in wants:
        for g, w in ((h, wh), (C, wC), (n, wn), (m, wm)):
            _close(g, w, TOL)


def test_chunk_not_dividing_the_sequence():
    """A chunk that does not divide L runs as one chunk in both packages
    (L 24, chunk 16)."""
    args = _cell_inputs(5, 2, 2, 24, 16)
    st = _state(6, 2, 2, 16)
    h, (C, n, m) = mlstm_chunkwise(*map(torch.from_numpy, args),
                                   tuple(map(torch.from_numpy, st)), chunk=16)
    wh, (wC, wn, wm) = JX.mlstm_chunkwise(*map(jnp.asarray, args),
                                          tuple(map(jnp.asarray, st)), 16)
    for g, w in ((h, wh), (C, wC), (n, wn), (m, wm)):
        _close(g, w, LAYER_TOL)


def test_oracle_matches_repros():
    """The port's float64 recurrence against ``repro``'s (which rounds
    its result to float32) from a carried state."""
    args = _cell_inputs(9, 2, 3, 20, 8)
    st = _state(10, 2, 3, 8)
    got = mlstm_ref(*map(torch.from_numpy, args), *map(torch.from_numpy, st))
    wh, (wC, wn, wm) = j_oracle(*args, *st)
    assert got[0].dtype == torch.float64
    for g, w in zip((got[0], *got[1]), (wh, wC, wn, wm)):
        _close(g, w, dict(rtol=1e-6, atol=1e-6))


def test_log_sigmoid_at_large_arguments():
    """``F.logsigmoid`` is ``jax.nn.log_sigmoid`` (-softplus(-x)) out to
    |x| = 100, where the gates of a trained model can sit, up to the
    subnormal results that XLA on the CPU flushes to zero (at x = 100,
    -3.9e-44 against -0.0; the kernel, built with -ftz=true, flushes
    them as XLA does)."""
    x = np.array([-100, -60, -30, -10, -1e-3, 0, 1e-3, 10, 30, 60, 100],
                 np.float32)
    got = torch.nn.functional.logsigmoid(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    tiny = np.finfo(np.float32).tiny
    normal = np.abs(got) >= tiny
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-6, atol=0)
    assert np.all(want[~normal] == 0) and np.all(np.abs(got[~normal]) < tiny)


# --------------------------------------------------------------------------
# blocks, with one SMOKE layer's weights
# --------------------------------------------------------------------------

def _layer(slot: str, seed: int):
    """SMOKE xlstm-1.3b weights of scan slot ``slot``'s first layer, as
    numpy (``repro``'s init), and the two configurations."""
    jcfg, pcfg = j_smoke(ARCH), p_smoke(ARCH)
    params = jax.tree.map(np.asarray, JM.init_params(
        JM.param_specs(jcfg), jax.random.PRNGKey(seed)))
    p = jax.tree.map(lambda a: a[0], params["scan"][slot]["mixer"])
    if "b_if" in p:                     # non-zero gate biases
        p["b_if"] = np.linspace(-1, 3, p["b_if"].size, dtype=np.float32)
    return jcfg, pcfg, p


def _x(seed, B, L, D):
    return (np.random.default_rng(seed).standard_normal((B, L, D))
            .astype(np.float32))


def test_headwise_norm_matches_repro():
    x = _x(3, 2, 5, 64) * 3
    g = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    got = PX._headwise_norm(torch.from_numpy(x), torch.from_numpy(g), 4, 1e-6)
    _close(got, JX._headwise_norm(jnp.asarray(x), jnp.asarray(g), 4, 1e-6),
           LAYER_TOL)


@pytest.mark.parametrize("L", [48, 40])
def test_mlstm_block_matches_repro(L):
    """Chunk 16: three chunks at L 48; at L 40 one chunk of 40."""
    jcfg, pcfg, p = _layer("s1", 11)
    x = _x(L, 2, L, jcfg.d_model)
    y, cache = PX.mlstm_block(pcfg, params_from_numpy(p), torch.from_numpy(x),
                              collect=True)
    wy, wcache = JX.mlstm_block(jcfg, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), collect=True)
    _close(y, wy, LAYER_TOL)
    assert cache.keys() == wcache.keys()
    for key in wcache:
        _close(cache[key], wcache[key], LAYER_TOL)


@pytest.mark.parametrize("continued", [False, True])
def test_slstm_block_matches_repro(continued):
    """From the zero state, and continuing the cache of a first prompt."""
    jcfg, pcfg, p = _layer("s0", 12)
    jp, pp = jax.tree.map(jnp.asarray, p), params_from_numpy(p)
    x = _x(13, 2, 24, jcfg.d_model)
    jc = pc = None
    if continued:
        x0 = _x(14, 2, 9, jcfg.d_model)
        _, jc = JX.slstm_block(jcfg, jp, jnp.asarray(x0), collect=True)
        pc = params_from_numpy(jax.tree.map(np.asarray, jc))
    y, cache = PX.slstm_block(pcfg, pp, torch.from_numpy(x), pc, collect=True)
    wy, wcache = JX.slstm_block(jcfg, jp, jnp.asarray(x), jc, collect=True)
    _close(y, wy, LAYER_TOL)
    assert cache.keys() == wcache.keys()
    for key in wcache:
        assert str(cache[key].dtype).removeprefix("torch.") == \
            str(wcache[key].dtype), key
        _close(cache[key], wcache[key], LAYER_TOL)


def test_float64_model_runs_in_float64():
    """The SMOKE prefill with float64 weights and compute dtype: every
    cache leaf and the logits are float64, within 1e-4 of the float32
    run, and the plain chunkwise form in float64 is the float64 oracle
    to 1e-10."""
    cfg = p_smoke(ARCH)
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    from repro_torch.models.params import init_params
    params = init_params(PM.param_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab,
                                                             (2, 32)))
    l32, c32 = PM.make_prefill_step(cfg)(params, {"tokens": tok})
    p64 = PM._tree_map(lambda t: t.double(), params)
    l64, c64 = PM.make_prefill_step(cfg64)(p64, {"tokens": tok})
    assert l64.dtype == torch.float64
    np.testing.assert_allclose(l64.numpy(), l32.double().numpy(), rtol=1e-4,
                               atol=1e-4)
    for slot, leaves in c64["scan"].items():
        for name, t in leaves.items():
            assert t.dtype == torch.float64, (slot, name)
            np.testing.assert_allclose(t.numpy(),
                                       c32["scan"][slot][name].double().numpy(),
                                       rtol=1e-4, atol=1e-4)
    args = [torch.from_numpy(a).double() for a in _cell_inputs(3, 1, 2, 40, 16)]
    h, st = mlstm_chunkwise(*args, chunk=8)
    rh, rst = mlstm_ref(*args, *init_mlstm_state(1, 2, 16, torch.float64))
    for g, w in zip((h, *st), (rh, *rst)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_bf16_prefill_caches_have_repros_dtypes():
    """In bf16 the mLSTM C and n are bf16, m and the sLSTM state float32,
    as ``repro``'s ``cache_specs`` declares them."""
    jcfg = dataclasses.replace(j_smoke(ARCH), compute_dtype="bfloat16")
    pcfg = dataclasses.replace(p_smoke(ARCH), compute_dtype="bfloat16")
    from repro_torch.models.params import init_params
    params = init_params(PM.param_specs(pcfg),
                         torch.Generator().manual_seed(2), "cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, pcfg.vocab,
                                                             (1, 20)))
    logits, caches = PM.make_prefill_step(pcfg)(params, {"tokens": tok})
    assert torch.isfinite(logits.float()).all()
    specs = JM.cache_specs(jcfg, 1, 20)
    for path, spec in specs.items():
        t = caches[path[0]][path[1]][path[2]]
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype).removeprefix("torch.") == spec.dtype, path


# --------------------------------------------------------------------------
# the kernel's precision design: bf16 pieces on the tensor cores
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e30])
def test_bf16_pieces_sum_back(scale):
    """Three pieces hold x to 2^-24 |x| (summed in float64); a bf16-exact
    x is its first piece, the other two zero."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(
        np.float32))
    pieces = bf16_pieces(x)
    assert len(pieces) == 3 and all(p.dtype == torch.bfloat16
                                    for p in pieces)
    back = sum(p.double() for p in pieces)
    assert ((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    exact = x.bfloat16().float()
    hi, mid, lo = bf16_pieces(exact)
    assert torch.equal(hi.float(), exact)
    assert not mid.float().any() and not lo.float().any()


def _tf32_pieces(x, n):
    """TF32 pieces (10 stored mantissa bits, round to nearest even), as
    float32."""
    rest, out = x.float(), []
    for _ in range(n):
        i = rest.view(torch.int32)
        p = ((i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
        out.append(p)
        rest = rest - p
    return out


def _product(a, b, na, nb, tf32=False):
    """a @ b as the tensor cores would take it: a in ``na`` pieces, b in
    ``nb``, the float32 sum over the pairs (i, j) with i + j < max(na,
    nb) (bf16 pieces: six products for 3 x 3, three for 3 x 1)."""
    def pieces(x, n):
        return (_tf32_pieces(x, n) if tf32
                else [p.float() for p in bf16_pieces(x, n)])
    pa, pb, n = pieces(a, na), pieces(b, nb), max(na, nb)
    return sum(pa[i] @ pb[j] for i in range(na) for j in range(nb)
               if i + j < n)


def _chunkwise_in_pieces(q, k, v, i_raw, f_raw, chunk, nx, ns, tf32=False):
    """The plain chunkwise form from the zero state with its four products
    taken as the kernel takes them: q, k, v in ``nx`` pieces, w v, S.D and
    the chunk-start state in ``ns``; the scale applied to S and to q C0^T
    after the product, as the kernel applies it."""
    B, H, L, Dh = q.shape
    scale = Dh ** -0.5
    C, n, m = init_mlstm_state(B, H, Dh)
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    hs = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, ic = q[:, :, sl], k[:, :, sl], v[:, :, sl], i_raw[:, :, sl]
        b = torch.cumsum(torch.nn.functional.logsigmoid(f_raw[:, :, sl]), -1)
        a = (b[..., :, None] - b[..., None, :] + ic[..., None, :]).masked_fill(
            ~tril, NEG)
        m_t = torch.maximum(b + m[..., None], a.amax(-1))
        SD = _product(qc, kc.transpose(-1, -2), nx, nx, tf32) * scale * \
            torch.exp(a - m_t[..., None])
        inter = torch.exp(b + m[..., None] - m_t)
        num = _product(SD, vc, ns, nx, tf32) + inter[..., None] * scale * \
            _product(qc, C.transpose(-1, -2), nx, ns, tf32)
        den = SD.sum(-1) + inter * scale * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        m_new = m_t[..., -1]
        wj = torch.exp(b[..., -1:] - b + ic - m_new[..., None])
        s = torch.exp(b[..., -1] + m - m_new)
        C = s[..., None, None] * C + _product(
            (vc * wj[..., None]).transpose(-1, -2), kc, ns, nx, tf32)
        n = s[..., None] * n + (wj[..., None, :] @ kc)[..., 0, :]
        m = m_new
    return torch.cat(hs, dim=2), (C, n, m)


@functools.lru_cache(maxsize=None)
def _oracle_case(shape, inputs):
    """Inputs drawn as tests/test_kernels.py draws them (q, k, v rounded
    to bf16 for ``inputs`` "bf16") and the float64 oracle's h, C, n, m."""
    B, H, L, Dh, _ = shape
    args = [torch.from_numpy(a) for a in _cell_inputs(L + Dh, B, H, L, Dh)]
    if inputs == "bf16":
        args[:3] = [t.bfloat16().float() for t in args[:3]]
    h, st = mlstm_ref(*args, *init_mlstm_state(B, H, Dh))
    return args, (h, *st)


# (pieces of q, k, v; pieces of w v, S.D, C0; TF32 pieces): the kernel's
# design for float32 and for bf16-exact inputs, one bf16 rounding of every
# operand, and three TF32 products (a_hi b_hi + a_hi b_lo + a_lo b_hi)
PIECES = {"3 bf16": (3, 3, False), "exact q, k, v": (1, 3, False),
          "one bf16": (1, 1, False), "3 tf32": (2, 2, True)}


@pytest.mark.parametrize("shape", [(1, 1, 256, 1024, 256),
                                   (1, 2, 128, 64, 32)])
@pytest.mark.parametrize("inputs,arith,holds", [
    ("float32", "3 bf16", True), ("bf16", "exact q, k, v", True),
    ("float32", "one bf16", False), ("float32", "3 tf32", True)])
def test_piece_products_hold_the_gate(shape, inputs, arith, holds):
    """The gate is 3e-4 + 3e-4 |oracle| (tests/test_kernels.py).  The
    kernel's products (three bf16 pieces of every operand that is not
    bf16-exact) hold it within 0.2 of it, for float32 and for bf16-exact
    q, k, v; one bf16 rounding of every operand fails it, so the pieces
    are needed; three TF32 products would hold it too."""
    args, want = _oracle_case(shape, inputs)
    h, st = _chunkwise_in_pieces(*args, shape[4], *PIECES[arith])
    worst = max(((g.double() - w).abs() / (3e-4 + 3e-4 * w.abs())).max().item()
                for g, w in zip((h, *st), want))
    assert (worst <= 0.2) if holds else (worst > 1.0), worst


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,layout", [
    (lambda: _bf16((2, 3, 5, 16)), (16, 3, 1)),
    (lambda: _bf16((3, 2, 5, 16)).transpose(0, 1), (16, 1, 2)),
    (lambda: _bf16((2, 3, 5, 24))[..., :20], (24, 3, 1)),
    (lambda: _bf16((2, 5, 3, 16)).transpose(1, 2), None),
    (lambda: _bf16((2, 3, 5, 16))[:, :, ::2], None),
    (lambda: _bf16((1, 3, 5, 16)).expand(2, 3, 5, 16), None)])
def test_input_layout(make, layout):
    """A contiguous head dim, rows at least Dh apart, and the B H matrices
    dense with the batch or the heads outermost (an einsum over heads
    leaves the second)."""
    assert input_layout(make()) == layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_block_passes_q_k_v_heads_outermost(dtype, monkeypatch):
    """The block's q, k, v come from the einsum 'blhd,hde->bhle', which
    leaves them with the heads outermost: the layout (Dh, 1, B) that the
    kernel reads in place rather than copying."""
    _, pcfg, p = _layer("s1", 11)
    seen = []

    def record(*args, **kw):
        seen.append(args[:3])
        return mlstm_chunkwise(*args, **kw)

    monkeypatch.setattr(PX, "mlstm_chunkwise", record)
    B, L = 2, 32
    params = PM._tree_map(lambda t: t.to(dtype), params_from_numpy(p))
    x = torch.from_numpy(_x(L, B, L, pcfg.d_model)).to(dtype)
    PX.mlstm_block(pcfg, params, x)
    (qkv,) = seen
    H, Dh = pcfg.n_heads, pcfg.d_mlstm // pcfg.n_heads
    assert H > 1
    for t in qkv:
        assert t.shape == (B, H, L, Dh) and t.dtype == dtype
        assert input_layout(t) == (Dh, 1, B)


@pytest.mark.parametrize("shape,transpose", [((2, 3, 33, 20), False),
                                             ((2, 17, 3, 16), True),
                                             ((1, 2, 9, 12), False)])
def test_tma_operand_pads_what_it_cannot_read_in_place(shape, transpose):
    t = torch.from_numpy(np.random.default_rng(6).standard_normal(
        shape).astype(np.float32)).bfloat16()
    t = t.transpose(1, 2) if transpose else t
    got = tma_operand(t)
    assert not reads_in_place(t) and reads_in_place(got)
    assert got.shape == t.shape and torch.equal(got, t)
    assert got.stride(2) % 8 == 0 and got.stride(2) >= t.shape[3]
    fine = _bf16((2, 4, 64, 1024))
    assert tma_operand(fine) is fine
