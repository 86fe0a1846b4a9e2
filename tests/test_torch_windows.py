"""The port's window plane against the JAX package's: the ``window_agg``
plain version against ``repro``'s reference and its Pallas kernel (in
interpret mode, as ``repro``'s own tests run it on the CPU), and
``push``/``reset_rows``/``aggregate`` (both window kinds) over a history.

Bitwise for every output while W <= 32: XLA on the CPU then sums the
window in index order, as the port does.  For W > 32 XLA sums in another
order, so there the sum and the mean are held to the bound of a
reordered float32 sum (stated at ``_sum_bound``); max, min and count stay
bitwise at every W."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core.windows as JW  # noqa: E402
import repro_torch.core.windows as PW  # noqa: E402
from repro.kernels.window_agg.ops import window_agg_op  # noqa: E402
from repro.kernels.window_agg.ref import window_agg_ref as j_ref  # noqa: E402
from repro_torch.kernels.window_agg.kernel import (  # noqa: E402
    RING_OFFSET, SMEM_LIMIT, STAGES, window_agg_plan)
from repro_torch.kernels.window_agg.ops import window_agg  # noqa: E402

EPS = float(np.finfo(np.float32).eps)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _rings(rng, N, W, C):
    """Windows with -0.0, NaN, +-inf-free magnitudes, subnormals, and
    counts that include 0 and W."""
    v = (rng.standard_normal((N, W, C)) * 10).astype(np.float32)
    flat = v.reshape(-1)
    flat[rng.integers(0, v.size, 6)] = -0.0
    flat[rng.integers(0, v.size, 6)] = 1e-40
    flat[rng.integers(0, v.size, 6)] = -3e-39
    v[2, 0, 0] = np.nan
    count = rng.integers(0, W + 1, N).astype(np.int32)
    count[0], count[1], count[2] = 0, W, W
    return v, count


def _sum_bound(v, count):
    """A reordered float32 sum of n terms differs from the index-order sum
    by at most 2 (n - 1) eps sum|x| (each order's error is at most
    (n - 1) eps sum|x|); the mean, one division of it, by that over the
    count plus one rounding of the mean itself."""
    W = v.shape[1]
    valid = (np.arange(W)[None, :] < count[:, None])[..., None]
    mag = np.where(valid, np.abs(v.astype(np.float64)), 0.0).sum(axis=1)
    n = np.maximum(count, 1).astype(np.float64)[:, None]
    return 2 * (W - 1) * EPS * mag, n


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("W", [1, 2, 8, 32, 33, 64, 256])
def test_window_agg_plain_matches_jax(W, C):
    rng = np.random.default_rng(W * 10 + C)
    N = 37                                  # no block size divides it
    v, count = _rings(rng, N, W, C)
    want = {k: np.asarray(x) for k, x in
            j_ref(jnp.asarray(v), jnp.asarray(count)).items()}
    got = window_agg(torch.from_numpy(v), torch.from_numpy(count))
    assert set(got) == set(want)
    exact = ("sum", "mean", "max", "min", "count") if W <= 32 \
        else ("max", "min", "count")
    for k in exact:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)
    if W > 32:
        bound, n = _sum_bound(v, count)
        for k, tol in (("sum", bound),
                       ("mean", bound / n + EPS * np.abs(want["mean"]))):
            g, w = got[k].numpy().astype(np.float64), want[k].astype(
                np.float64)
            both_nan = np.isnan(g) & np.isnan(w)
            assert (both_nan | (np.abs(g - w) <= tol)).all(), k
            assert (np.isnan(g) == np.isnan(w)).all(), k


@pytest.mark.parametrize("W,C", [(8, 1), (16, 4)])
def test_window_agg_plain_matches_pallas_interpret(W, C):
    """Against the Pallas kernel itself (interpret mode on the CPU), at a
    stream count its block size divides."""
    rng = np.random.default_rng(3)
    v, count = _rings(rng, 16, W, C)
    want = window_agg_op(jnp.asarray(v), jnp.asarray(count), block_n=8,
                         interpret=True)
    got = window_agg(torch.from_numpy(v), torch.from_numpy(count))
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]),
                                      _bits(np.asarray(want[k])), err_msg=k)


def test_window_agg_wrapper_needs_the_card_for_the_kernel():
    v = torch.zeros((3, 4, 2))
    c = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        window_agg(v, c, use_kernel=True)
    out = window_agg(v, c, use_kernel=False)
    assert set(out) == {"sum", "mean", "max", "min", "count"}
    for k in out:
        assert out[k].shape == (3, 2) and not out[k].any()


@pytest.mark.parametrize("N,W,C,aligned,want", [
    (3586, 256, 4, True, "bulk"),       # the IoT suite's store
    (4096, 1024, 4, True, "bulk"),
    (4096, 1024, 4, False, "load4"),    # an unaligned base
    (37, 5, 3, True, "load4"),          # W C % 4 != 0
    (37, 5, 3, False, "load4"),
    (37, 8, 4, False, "load4"),
    (99, 33, 1, True, "load4"),
    (99, 8, 40, True, "bulk"),          # two warps a stream
    (5, 1, 4, True, "bulk"),
    (7, 2, 3000, True, "bulk"),         # the smallest chunk
])
def test_window_agg_plan(N, W, C, aligned, want):
    """The staging plan the launcher passes to the kernel: bulk copies
    exactly where a ring row and the base are 16-byte aligned, else
    4-byte copies, with the alignment changing nothing else; chunks of a
    multiple of 4 entries; a row pitch of a multiple of 16 bytes that is
    16 mod 128; the shared bytes of one warp's ring stages within one
    CTA's limit; one-warp CTAs covering every stream and channel."""
    plan = window_agg_plan(N, W, C, aligned)
    assert plan.staging == want
    G, parts = plan.streams_per_warp, plan.warps_per_stream
    assert G == 32 // min(C, 32) and parts == -(-C // 32)
    assert plan.blocks == -(-N // G) * parts
    assert plan.chunk % 4 == 0 and 4 <= plan.chunk <= 64
    assert plan.chunk <= max(4, -(-W // 4) * 4)
    assert plan.pitch % 16 == 0 and plan.pitch % 128 == 16
    assert plan.pitch >= plan.chunk * C * 4
    assert plan.smem_bytes == RING_OFFSET + STAGES * G * plan.pitch \
        <= SMEM_LIMIT
    if want == "bulk":
        # every chunk starts on a 16-byte boundary of its stream's row
        assert (W * C) % 4 == 0 and (plan.chunk * C) % 4 == 0
    other = window_agg_plan(N, W, C, not aligned)
    assert other._replace(staging=want) == plan


def test_window_agg_plan_refuses_what_no_cta_holds():
    with pytest.raises(ValueError, match="shared bytes"):
        window_agg_plan(4, 4, 5000)
    with pytest.raises(ValueError, match="N, W, C >= 1"):
        window_agg_plan(4, 0, 4)


def _assert_store(js, ps):
    for f in js._fields:
        np.testing.assert_array_equal(_bits(getattr(ps, f)),
                                      _bits(np.asarray(getattr(js, f))),
                                      err_msg=f)


@pytest.mark.parametrize("W", [4, 32])
def test_push_reset_aggregate_match_jax(W):
    """A history of masked ring inserts (rings wrapping past 2W pushes),
    a batched and a scalar reset, then both window kinds: the store and
    every aggregate bitwise."""
    rng = np.random.default_rng(W)
    N, C = 12, 3
    js = JW.init_window_store(N, W, C)
    ps = PW.init_window_store(N, W, C, device="cpu")
    for r in range(8 * W):
        sid = np.unique(rng.integers(0, N, 7)).astype(np.int32)
        B = sid.shape[0]
        vals = (rng.standard_normal((B, C)) * 5).astype(np.float32)
        vals.reshape(-1)[rng.integers(0, vals.size, 2)] = -0.0
        ts = rng.integers(0, 1000, B).astype(np.int32)
        mask = rng.random(B) < 0.8
        js = JW.push(js, jnp.asarray(sid), jnp.asarray(vals),
                     jnp.asarray(ts), jnp.asarray(mask))
        ps = PW.push(ps, torch.from_numpy(sid), torch.from_numpy(vals),
                     torch.from_numpy(ts), torch.from_numpy(mask))
        if r == W:
            js = JW.reset_rows(js, jnp.asarray([1, 5], jnp.int32))
            ps = PW.reset_rows(ps, [1, 5])
        if r == 2 * W:
            js = JW.reset_rows(js, 7)
            ps = PW.reset_rows(ps, 7)
        _assert_store(js, ps)
    assert int(ps.ptr.max()) < 2 * W and int(ps.total.max()) > 2 * W
    for horizon in (None, 500, 10 ** 6):       # 10**6: every entry stale
        want = JW.aggregate(js, horizon=horizon, use_kernel=False)
        got = PW.aggregate(ps, horizon=horizon)
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]),
                                          _bits(np.asarray(want[k])),
                                          err_msg=f"{horizon} {k}")
        if horizon == 10 ** 6:
            # the +-3e38 sentinels never leak out of an all-stale window
            for k in got:
                assert not got[k].any(), k
