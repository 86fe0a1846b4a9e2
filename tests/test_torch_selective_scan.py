"""The port's selective scan (its plain version, the CPU path and the
oracle the CUDA kernel is held to on the card) against the JAX package's
sequential ``selective_scan_ref``, its Pallas kernel in interpret mode
(``ssm_scan_pallas``) and its model plane's chunked ``ssm_scan``, at the
sweep of ``tests/test_kernels.py`` and decode-shaped rows (L 1 and 2) and
1e-4, as there; then the whole ``mamba_block`` (jamba's ``ssm_norm`` on
and off) against ``repro``'s; and the CUDA launcher's plan, which needs
no card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_smoke  # noqa: E402
from repro.kernels.selective_scan.ops import ssm_scan_pallas  # noqa: E402
from repro.kernels.selective_scan.ref import selective_scan_ref as j_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_smoke as p_smoke  # noqa: E402
from repro_torch.kernels.selective_scan.kernel import (  # noqa: E402
    REGISTER_THREADS, RING_FLOATS, RING_STEPS, SMEM_LIMIT, SMS,
    ring_smem_bytes, selective_scan_plan)
from repro_torch.kernels.selective_scan.ops import selective_scan  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SWEEP = [(1, 16, 32, 8, 8, 16), (2, 64, 128, 16, 16, 64),
         (1, 128, 256, 16, 32, 128),
         (4, 1, 64, 16, 1, 64), (4, 2, 64, 16, 1, 32)]   # decode-shaped
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, L, Di, S):
    rng = np.random.default_rng(seed)
    return (np.exp(-np.abs(rng.standard_normal((B, L, Di, S)))).astype(np.float32),
            rng.standard_normal((B, L, Di, S)).astype(np.float32),
            rng.standard_normal((B, L, S)).astype(np.float32),
            rng.standard_normal((B, Di, S)).astype(np.float32))


@pytest.mark.parametrize("B,L,Di,S,bt,bd", SWEEP)
@pytest.mark.parametrize("chunk", [8, 256])
def test_plain_matches_repro(B, L, Di, S, bt, bd, chunk):
    """``chunk`` is that of ``repro``'s chunked ``ssm_scan``."""
    args = _inputs(L + Di, B, L, Di, S)
    y, h = selective_scan(*map(torch.from_numpy, args))
    for wy, wh in (j_ref(*args),
                   ssm_scan_pallas(*map(jnp.asarray, args), blk_t=bt,
                                   blk_d=bd, interpret=True),
                   JS.ssm_scan(*map(jnp.asarray, args), chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_chunk_not_dividing_the_sequence():
    """``repro`` runs a chunk that does not divide L as one chunk (L 24,
    chunk 16); the port's single pass agrees."""
    args = _inputs(5, 2, 24, 16, 4)
    y, h = selective_scan(*map(torch.from_numpy, args))
    wy, wh = JS.ssm_scan(*map(jnp.asarray, args), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


@pytest.mark.parametrize("S", [8, 6])
def test_plain_is_the_sequential_recurrence(S):
    """The plain version against the recurrence written out step by step
    in float64 (S a power of two and not), far inside the sweep's 1e-4."""
    a, bx, c, h0 = _inputs(7 + S, 2, 20, 12, S)
    y, h = selective_scan(*map(torch.from_numpy, (a, bx, c, h0)))
    hh, wy = h0.astype(np.float64), []
    for t in range(20):
        hh = a[:, t] * hh + bx[:, t]
        wy.append(np.einsum("bds,bs->bd", hh, c[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(wy, 1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), hh, rtol=1e-5, atol=1e-5)


def test_ssm_scan_is_the_kernels_entry():
    args = [torch.from_numpy(a) for a in _inputs(6, 1, 32, 8, 4)]
    y, h = PS.ssm_scan(*args)
    y2, h2 = selective_scan(*args, use_kernel=False)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    with pytest.raises(ValueError, match="CUDA"):
        PS.ssm_scan(*args, use_kernel=True)


@pytest.mark.parametrize("ssm_norm", [True, False])
def test_mamba_block_matches_repro(ssm_norm):
    jcfg = dataclasses.replace(j_smoke("jamba-v0.1-52b"), ssm_norm=ssm_norm)
    pcfg = dataclasses.replace(p_smoke("jamba-v0.1-52b"), ssm_norm=ssm_norm)
    specs = {p[3:]: s for p, s in JM.param_specs(jcfg).items()
             if p[:3] == ("scan", "s0", "mixer")}
    params = jax.tree.map(lambda a: np.asarray(a)[0], JM.init_params(
        {("x",) + p: s for p, s in specs.items()}, jax.random.PRNGKey(3))["x"])
    x = np.random.default_rng(8).standard_normal((2, 48, pcfg.d_model)
                                                 ).astype(np.float32)
    y, cache = PS.mamba_block(pcfg, params_from_numpy(params),
                              torch.from_numpy(x), collect=True)
    wy, wcache = JS.mamba_block(jcfg, jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x), collect=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wcache[k]),
                                   **TOL)


@pytest.mark.parametrize("B,L,Di,S,aligned,path,states", [
    (1, 4096, 8192, 16, True, "ring", 4),       # jamba's Mamba layer
    (1, 4096, 8192, 16, False, "register", 1),  # an unaligned base
    (4, 1, 8192, 16, True, "register", 4),      # jamba's decode shape
    (4, 1, 8192, 16, False, "register", 1),
    (2, RING_STEPS - 1, 64, 16, True, "register", 4),
    (2, RING_STEPS, 64, 16, True, "ring", 4),   # one chunk
    (2, RING_STEPS + 1, 333, 8, True, "ring", 4),
    (3, 300, 333, 32, True, "ring", 4),
    (3, 300, 333, 4, True, "ring", 4),
    (2, 33, 8200, 16, True, "ring", 4),         # enough CTAs for 2 KB rows
    (1, 300, 4096, 16, True, "ring", 4),        # too few: 1 KB rows
    (2, 300, 333, 2, True, "register", 1),      # S < 4: one state a thread
    (2, 1, 333, 1, True, "register", 1),
])
def test_selective_scan_plan(B, L, Di, S, aligned, path, states):
    """The launch plan the launcher passes to the kernel: four states a
    thread exactly where S >= 4 and the bases are aligned; the ring path
    exactly for those at L of a chunk or more, with rows of C S = 512
    floats, halved where fewer CTAs than SMs would run, each row a
    whole number of 16-byte units (a bulk copy's), the shared bytes within
    a CTA's limit; else the register path's 256-thread CTAs.  Either way
    one thread a (batch, channel, states) group and CTAs over every
    channel."""
    plan = selective_scan_plan(B, L, Di, S, aligned)
    assert (plan.path, plan.states) == (path, states)
    lanes = S // states
    assert plan.threads == plan.channels * lanes
    assert plan.grid == (-(-Di // plan.channels), B)
    if path == "ring":
        assert L >= RING_STEPS and S >= 4
        full = B * -(-Di // (RING_FLOATS // S)) >= SMS
        assert plan.channels * S == (RING_FLOATS if full else RING_FLOATS // 2)
        assert plan.channels * S * 4 % 16 == 0
        assert plan.smem_bytes == ring_smem_bytes(S, plan.channels) \
            <= SMEM_LIMIT
        assert plan.grid[0] * plan.grid[1] >= SMS or not full
    else:
        assert plan.threads == REGISTER_THREADS and plan.smem_bytes == 0
        assert L < RING_STEPS or states == 1
    if states == 4:
        other = selective_scan_plan(B, L, Di, S, not aligned)
        assert (other.path, other.states) == ("register", 1)


def test_selective_scan_plan_at_jamba():
    """Jamba's decode shape is one wave of 131,072 threads (512 CTAs of
    256, at most 4 an SM's 2,048 threads); its Mamba layer runs 256 ring
    CTAs of 128 threads (2 KB rows), every SM with work."""
    dec = selective_scan_plan(4, 1, 8192, 16)
    assert dec.grid[0] * dec.grid[1] * dec.threads == 131072
    assert dec.grid[0] * dec.grid[1] <= SMS * (2048 // dec.threads)
    pre = selective_scan_plan(1, 4096, 8192, 16)
    assert (pre.channels, pre.threads, pre.grid) == (32, 128, (256, 1))


def test_selective_scan_plan_refuses():
    for shape in ((1, 8, 4, 3), (1, 0, 4, 4), (70000, 1, 4, 4)):
        with pytest.raises(ValueError, match="selective_scan takes"):
            selective_scan_plan(*shape)
