"""The port's Mixture-of-Experts against the JAX package's, on the CPU:
``dispatch_combine`` exactly, ``topk_route``'s order exactly on ties
(``lax.top_k`` takes the lower index), ``load_balance_loss``, and
``moe_block`` at jamba's SMOKE widths, with a shared gated expert, and
with a capacity that Python's half-even ``round`` sets (2.5 -> 2)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import get_smoke as p_smoke  # noqa: E402
from repro_torch.models import moe as PMoE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


@pytest.mark.parametrize("G,S,K,E,C", [(2, 16, 2, 4, 8), (3, 32, 2, 8, 3),
                                       (1, 12, 3, 5, 12), (2, 9, 1, 3, 1)])
def test_dispatch_combine_exact(G, S, K, E, C):
    rng = np.random.default_rng([G, S, K, E, C])
    idx = np.stack([rng.permutation(E)[:K] for _ in range(G * S)]
                   ).reshape(G, S, K).astype(np.int32)
    gates = rng.random((G, S, K)).astype(np.float32)
    d, c = PMoE.dispatch_combine(torch.from_numpy(idx), torch.from_numpy(gates),
                                 E, C)
    dj, cj = JMoE.dispatch_combine(jnp.asarray(idx), jnp.asarray(gates), E, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))


@pytest.mark.parametrize("renorm", [True, False])
def test_topk_route_ties_take_the_lower_index(renorm):
    rng = np.random.default_rng(1)
    logits = rng.integers(-2, 3, (6, 10, 8)).astype(np.float32)  # many ties
    logits[0, 0] = 0.0                                           # all equal
    g, i, p = PMoE.topk_route(torch.from_numpy(logits), 3, renorm)
    gj, ij, pj = JMoE.topk_route(jnp.asarray(logits), 3, renorm)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(i[0, 0].numpy(), [0, 1, 2])
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
    lb = PMoE.load_balance_loss(i, p, 8)
    np.testing.assert_allclose(float(lb), float(JMoE.load_balance_loss(ij, pj, 8)),
                               rtol=1e-6)


def _moe_params(cfg, seed):
    specs = {p[3:]: s for p, s in JM.param_specs(cfg).items()
             if p[:3] == ("scan", "s1", "mlp")}
    tree = JM.init_params({("x",) + p: s for p, s in specs.items()},
                          jax.random.PRNGKey(seed))["x"]
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


@pytest.mark.parametrize("variant", ["smoke", "shared_gated", "half_even_cap"])
def test_moe_block_matches_repro(variant):
    kw = {"smoke": {},
          "shared_gated": dict(n_shared=1, shared_gate=True),
          # capacity 4 * 1 * 1.25 / 2 = 2.5: Python rounds it to 2, so
          # tokens past the second per expert are dropped
          "half_even_cap": dict(moe_group=4, top_k=1, capacity_factor=1.25,
                                n_experts=2)}[variant]
    jcfg = dataclasses.replace(j_smoke("jamba-v0.1-52b"), **kw)
    pcfg = dataclasses.replace(p_smoke("jamba-v0.1-52b"), **kw)
    params = _moe_params(jcfg, 5)
    x = np.random.default_rng(9).standard_normal((2, 32, pcfg.d_model)
                                                 ).astype(np.float32)
    y, aux = PMoE.moe_block(pcfg, params_from_numpy(params), torch.from_numpy(x))
    wy, waux = JMoE.moe_block(jcfg, jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
