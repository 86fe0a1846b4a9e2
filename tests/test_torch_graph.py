"""The port's ``core/graph.py`` against the JAX package's: every analysis
of ``PipelineGraph`` on the topologies of ``tests/test_graph.py`` and on
a registry built alike in both packages; then the port's engine, with
the stream-dispatch fan-out, emits and discards what the graph predicts
(the counterpart of ``tests/test_graph.py``'s engine cross-check)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.kernels.stream_dispatch.ops import make_fanout  # noqa: E402

FIG3 = [[], [], [0, 1, 3], [5], [6, 7, 1], [2], [2], [2]]


def _analyses(g):
    """Every result ``PipelineGraph`` computes, as plain Python values."""
    out = {
        "outputs": g.outputs, "sources": g.sources(), "sinks": g.sinks(),
        "edges": g.edges(), "in": g.in_degrees().tolist(),
        "out": g.out_degrees().tolist(), "table1": g.table1_metrics(),
        "connected": g.is_weakly_connected(),
        "depth": g.depth_from_sources().tolist(), "length": g.length(),
        "anc": [sorted(a) for a in g.ancestor_sources()],
        "topo": g._topo_order(), "novelty": g.novelty_distance().tolist(),
    }
    for s in range(g.n):
        out[f"tree{s}"] = g.execution_tree(s)
        out[f"discarded{s}"] = g.discarded_edges(s)
        out[f"drain{s}"] = g.rounds_to_drain(s)
    return out


def _random_inputs(seed, n=30, n_src=6):
    rng = np.random.default_rng(seed)
    ins = [[] for _ in range(n_src)]
    for v in range(n_src, n):
        k = int(rng.integers(1, 4))
        ins.append(sorted(rng.choice(n, k, replace=False).tolist()))
    return ins


@pytest.mark.parametrize("inputs", [FIG3, _random_inputs(1),
                                    _random_inputs(2), [[]], [[], [0]]],
                         ids=["fig3", "random1", "random2", "one", "edge"])
def test_graph_equals_repro(inputs):
    """Cycles included (Fig. 3's d -> c, and the random graphs')."""
    names = [f"n{i}" for i in range(len(inputs))]
    gj = J.PipelineGraph(n=len(inputs), inputs=inputs, node_names=names)
    gp = P.PipelineGraph(n=len(inputs), inputs=inputs, node_names=names)
    assert _analyses(gp) == _analyses(gj)


def test_fig3_execution_tree_and_discards():
    g = P.PipelineGraph(n=8, inputs=FIG3, node_names=list("abcdefgh"))
    assert set(g.execution_tree(0)) == {0, 2, 3, 4, 5, 6, 7}
    disc = g.discarded_edges(0)
    assert (3, 2) in disc and sum(1 for _, v in disc if v == 4) == 1
    assert g.rounds_to_drain(0) == 3


def _diamond(mod):
    """a -> f, a -> g, {f, g} -> x, x -> y: x's second delivery of one
    update is discarded."""
    cfg = mod.EngineConfig(n_streams=16, batch=8, queue=64, max_in=4,
                           max_out=4, fused_round=False)
    reg = mod.Registry(cfg)
    t = reg.create_tenant("t")
    a = reg.create_stream(t, "a", ["v"])
    f = reg.create_composite(t, "f", ["v"], [a], transform={"v": "a.v"})
    g = reg.create_composite(t, "g", ["v"], [a], transform={"v": "a.v"})
    x = reg.create_composite(t, "x", ["v"], [f, g],
                             transform={"v": "f.v + g.v"})
    reg.create_composite(t, "y", ["v"], [x], transform={"v": "x.v * 2"})
    return reg, a


def test_registry_graph_equals_repro():
    gj = J.PipelineGraph.from_registry(_diamond(J)[0])
    gp = P.PipelineGraph.from_registry(_diamond(P)[0])
    assert gp.node_names == gj.node_names
    assert _analyses(gp) == _analyses(gj)


def test_engine_discards_what_the_graph_predicts():
    """One update through the diamond on the port's staged engine with
    the dispatch fan-out: every composite of the execution tree emits
    once, each discarded edge's delivery arrives in the same round as
    the tree edge's and is coalesced into it (the winner rule the tree
    models), and the update drains in the tree's height."""
    reg, a = _diamond(P)
    graph = P.PipelineGraph.from_registry(reg)
    tree = graph.execution_tree(a.sid)
    eng = P.create_engine(reg, device="cpu", fanout_fn=make_fanout())
    assert eng._path == "staged"
    eng.post(a, [1.0], ts=1)
    rounds = eng.drain()
    c = eng.counters()
    n_disc = len(graph.discarded_edges(a.sid))
    assert c["emitted"] == len(tree) - 1
    assert c["coalesced"] == n_disc == 1
    assert c["processed"] == len(tree) - 1 + n_disc
    assert len(rounds) == graph.rounds_to_drain(a.sid) == 3
    assert eng.value_of(reg.streams[-1])[0] == 4.0
