"""Subscription-graph analysis: Table-I metrics, execution trees, novelty.

Host-side (numpy) analysis of the pipeline DAG built from the registry —
the port's own copy of the JAX package's ``repro.core.graph`` (that
package's ``repro.core`` imports jax; this module needs only numpy and
reads a :class:`~repro_torch.core.registry.Registry` the same way).
Implements the paper's §IV-E reasoning:

  * **execution trees** — under the timestamp-discard rule, the set of
    computations actually triggered by one source forms a tree (first
    arrival wins; later arrivals of the same logical update are discarded);
    we compute it as the BFS/shortest-hop tree from each source,
  * **novelty** — a stream is maximally novel when one of its inputs
    carries a source no other input carries; novelty *distance* grows with
    hops since the last new-source addition,
  * **Table I metrics** — in/out-degree stats, density, connectivity, used
    by the benchmark generator to match the paper's topologies,
  * **discard prediction** — edges whose deliveries are always discarded
    (the `d→c`, `h→e` edges of Fig. 3), used to validate engine counters.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineGraph:
    n: int
    inputs: List[List[int]]      # per node, ordered input node ids
    node_names: Optional[List[str]] = None

    @property
    def outputs(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.n)]
        for v, ins in enumerate(self.inputs):
            for u in ins:
                if v not in out[u]:
                    out[u].append(v)
        return out

    @classmethod
    def from_registry(cls, registry) -> "PipelineGraph":
        # revoked sids leave None holes in the registry; they render as
        # isolated, unnamed nodes
        n = len(registry.streams)
        return cls(
            n=n,
            inputs=[list(s.inputs) if s is not None else []
                    for s in registry.streams],
            node_names=[s.name if s is not None else f"<revoked {i}>"
                        for i, s in enumerate(registry.streams)],
        )

    # ------------------------------------------------------------- basics
    def sources(self) -> List[int]:
        return [v for v in range(self.n) if not self.inputs[v]]

    def sinks(self) -> List[int]:
        outs = self.outputs
        return [v for v in range(self.n) if not outs[v]]

    def edges(self) -> List[Tuple[int, int]]:
        return [(u, v) for v, ins in enumerate(self.inputs) for u in ins]

    def in_degrees(self) -> np.ndarray:
        return np.array([len(i) for i in self.inputs])

    def out_degrees(self) -> np.ndarray:
        return np.array([len(o) for o in self.outputs])

    # --------------------------------------------------------- Table I row
    def table1_metrics(self) -> Dict[str, float]:
        ind = self.in_degrees()
        outd = self.out_degrees()
        comp = ind > 0            # composites (operators)
        n_edges = len(self.edges())
        density = n_edges / (self.n * (self.n - 1)) if self.n > 1 else 0.0
        return {
            "max_in_degree": int(ind.max(initial=0)),
            "mean_in_degree": float(ind[comp].mean()) if comp.any() else 0.0,
            "in_degree_std": float(ind[comp].std()) if comp.any() else 0.0,
            "max_out_degree": int(outd.max(initial=0)),
            "mean_out_degree": float(outd[outd > 0].mean()) if (outd > 0).any() else 0.0,
            "out_degree_std": float(outd[outd > 0].std()) if (outd > 0).any() else 0.0,
            "edges": n_edges,
            "nodes": self.n,
            "sources": len(self.sources()),
            "sinks": len(self.sinks()),
            "density": density,
            "connected": float(self.is_weakly_connected()),
        }

    def is_weakly_connected(self) -> bool:
        if self.n == 0:
            return True
        adj: List[Set[int]] = [set() for _ in range(self.n)]
        for u, v in self.edges():
            adj[u].add(v)
            adj[v].add(u)
        seen = {0}
        dq = deque([0])
        while dq:
            x = dq.popleft()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    dq.append(y)
        return len(seen) == self.n

    # ------------------------------------------------------ execution tree
    def execution_tree(self, source: int) -> Dict[int, int]:
        """Parent map of the execution tree rooted at ``source`` (§IV-E).

        First delivery wins: BFS order, ties broken by lower parent id —
        matching the engine's winner rule (earliest work item in the round).
        Nodes not reachable from ``source`` are absent.
        """
        outs = self.outputs
        parent: Dict[int, int] = {source: -1}
        frontier = [source]
        while frontier:
            nxt: List[int] = []
            for u in sorted(frontier):
                for v in outs[u]:
                    if v not in parent:
                        parent[v] = u
                        nxt.append(v)
            frontier = nxt
        return parent

    def discarded_edges(self, source: int) -> List[Tuple[int, int]]:
        """Edges reachable from ``source`` whose deliveries are discarded
        (they are not part of the execution tree — Fig. 3b)."""
        parent = self.execution_tree(source)
        outs = self.outputs
        disc = []
        for u in parent:
            for v in outs[u]:
                if v in parent and parent[v] != u:
                    disc.append((u, v))
        return disc

    def depth_from_sources(self) -> np.ndarray:
        """Min hop distance from any source (the scheduler priority of
        §V-C: 'room for improvement by prioritizing nodes near the
        sources')."""
        outs = self.outputs
        depth = np.full(self.n, np.iinfo(np.int32).max, np.int64)
        dq = deque()
        for s in self.sources():
            depth[s] = 0
            dq.append(s)
        while dq:
            u = dq.popleft()
            for v in outs[u]:
                if depth[u] + 1 < depth[v]:
                    depth[v] = depth[u] + 1
                    dq.append(v)
        return depth

    def length(self) -> int:
        """Max composite-hops from a source to any sink (paper 'length')."""
        d = self.depth_from_sources()
        finite = d[d < np.iinfo(np.int32).max]
        return int(finite.max(initial=0))

    # ------------------------------------------------------------ novelty
    def ancestor_sources(self) -> List[Set[int]]:
        """Per node, the set of sources feeding it (transitively)."""
        anc: List[Set[int]] = [set() for _ in range(self.n)]
        order = self._topo_order()
        for v in order:
            if not self.inputs[v]:
                anc[v] = {v}
            else:
                s: Set[int] = set()
                for u in self.inputs[v]:
                    s |= anc[u]
                anc[v] = s
        return anc

    def _topo_order(self) -> List[int]:
        """Topological order; cycles broken by ignoring back edges (the
        paper allows cycles — Fig. 2b — whose deliveries are discarded)."""
        indeg = {v: 0 for v in range(self.n)}
        outs = self.outputs
        for u, v in self.edges():
            indeg[v] += 1
        dq = deque(v for v in range(self.n) if indeg[v] == 0)
        order: List[int] = []
        seen = set()
        while dq:
            u = dq.popleft()
            if u in seen:
                continue
            seen.add(u)
            order.append(u)
            for v in outs[u]:
                indeg[v] -= 1
                if indeg[v] <= 0 and v not in seen:
                    dq.append(v)
        # nodes stuck in cycles: append in id order (their ancestor sets
        # are computed best-effort, consistent with discard semantics)
        for v in range(self.n):
            if v not in seen:
                order.append(v)
        return order

    def novelty_distance(self) -> np.ndarray:
        """0 = source, or merges a source no other input carries;
        else 1 + min over inputs (hops since last new-source addition)."""
        anc = self.ancestor_sources()
        nov = np.zeros(self.n, np.int64)
        order = self._topo_order()
        for v in order:
            ins = self.inputs[v]
            if not ins:
                nov[v] = 0
                continue
            novel = False
            if len(ins) > 1:
                for i, u in enumerate(ins):
                    others: Set[int] = set()
                    for j, w in enumerate(ins):
                        if j != i:
                            others |= anc[w]
                    if anc[u] - others:
                        novel = True
                        break
            nov[v] = 0 if novel else 1 + min(int(nov[u]) for u in ins)
        return nov

    # ----------------------------------------------------------- rounds
    def rounds_to_drain(self, source: int) -> int:
        """Engine rounds needed to propagate one SU from ``source`` to all
        reachable streams (== tree height; the batched engine advances one
        hop per round)."""
        parent = self.execution_tree(source)
        if len(parent) <= 1:
            return 0
        depth = {source: 0}
        # BFS again for depths
        outs = self.outputs
        dq = deque([source])
        while dq:
            u = dq.popleft()
            for v in outs[u]:
                if v in parent and parent[v] == u and v not in depth:
                    depth[v] = depth[u] + 1
                    dq.append(v)
        return max(depth.values())
