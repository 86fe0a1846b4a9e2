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
in float64 throughout."""
import dataclasses

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
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunkwise  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (init_mlstm_state,  # noqa: E402
                                                 mlstm_ref)
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
