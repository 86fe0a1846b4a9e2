"""Model-backed streams: the bridge between the paper's pub/sub runtime
and the model plane (the port of ``repro.serving.bridge``).

A composite stream flagged ``model_backed`` does not run VM bytecode for
its value — its emitted SUs are *requests* to a model service.  Each
engine round's SinkBatch is scanned for model-backed emissions; they are
tokenized (here: channel values quantized into the vocab — the modality
frontend of a real deployment), submitted to the ContinuousBatcher, and
completions are posted back into the engine as fresh SUs on the response
stream — re-entering the pipeline like any other Sensor Update.

This makes an LM just another multi-tenant subscriber: tenants compose
"raw stream -> transform -> LM scorer -> downstream aggregation" pipelines
with the exact subscription semantics of the paper.

Backpressure (QoS plane): with a ``watermark``, the bridge consults the
engine's per-tenant queue occupancy (``engine.tenant_backlog``) before
submitting — a tenant whose occupancy crossed the watermark has its pump
*slowed*: its emissions are deferred host-side (and its queued batcher
requests are not admitted to decode slots) until the backlog drains below
the watermark again.  Other tenants' requests flow unimpeded.

Elasticity: routes survive ``engine.resize`` untouched.  They hold
registry ``Stream`` objects and global sids, both of which are placement-
independent, and ``resize`` morphs the engine *in place* (same object,
same registry), so ``self.engine`` stays the live engine across any
number of scale events — sids never change owner identity, only owner
shard.  Use :meth:`rebind` only when replacing the engine object itself
(e.g. after ``restore_engine``, which builds a new instance).

The host arithmetic is ``repro``'s numpy: tokens in int64, the score in
float64.  Sinks and spools may hold device tensors; each field is read
back once per pump.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import SinkBatch, SinkSpool, StreamEngine
from repro_torch.serving.batcher import ContinuousBatcher, Request


def _host(x) -> np.ndarray:
    """A sink or spool field as a host array (one readback for a tensor)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class _Route:
    source_sid: int
    response_stream: object          # registry Stream
    prompt_len: int = 8
    tenant: int = 0                  # owner of the model stream (QoS)


class ModelBackedStreams:
    """Routes model-backed streams' emissions from ``engine`` to
    ``batcher`` and posts the completions back as SUs; ``watermark`` (per
    tenant queue occupancy) turns on backpressure."""

    def __init__(self, engine: StreamEngine, batcher: ContinuousBatcher,
                 watermark: Optional[int] = None):
        self.engine = engine
        self.batcher = batcher
        self.watermark = watermark
        self.routes: Dict[int, _Route] = {}
        self._next_rid = 0
        self.inflight: Dict[int, _Route] = {}
        self._rid_its: Dict[int, Optional[int]] = {}   # ingest stamp per rid
        self.completed: List[Request] = []
        self.deferred: List[Tuple[int, np.ndarray, Optional[int]]] = []
        self._occ: Optional[np.ndarray] = None   # host occupancy snapshot
        self._qmask: Optional[np.ndarray] = None  # host quarantine snapshot
        self.dropped_quarantined = 0   # emissions dropped at the bridge
        if watermark is not None and hasattr(batcher, "throttle"):
            # the batcher half of the hook: backlogged tenants' queued
            # requests wait for a decode slot until they drain
            batcher.throttle = lambda req: self._throttled(req.tenant)

    def _throttled(self, tenant: int) -> bool:
        """True when ``tenant``'s engine queue occupancy has crossed the
        backpressure watermark (always False with no watermark set).
        Occupancy is read from a host snapshot taken at most once per
        pump/drain burst — the engine only advances between bursts, so
        the snapshot is exact while avoiding a blocking device readback
        per queued request."""
        if self.watermark is None:
            return False
        if self._occ is None:
            self._occ = np.asarray(self.engine.tenant_backlog())
        return int(self._occ[tenant]) > self.watermark

    def _refresh_backpressure(self) -> None:
        """Drop the occupancy + quarantine snapshots (the engine may have
        advanced)."""
        self._occ = None
        self._qmask = None

    def _quarantined(self, sid: int) -> bool:
        """True when the circuit breaker has quarantined ``sid`` — read
        from a host snapshot taken at most once per pump/drain burst (the
        same one-readback pattern as :meth:`_throttled`).  Emissions from
        a quarantined source already in the spool or the deferred list are
        poison-adjacent by definition: they were produced before the trip
        landed, so the bridge drops them instead of spending model slots
        on them."""
        qm = self._qmask
        if qm is None:
            qm = self._qmask = np.asarray(
                self.engine.fault_counters()["quarantined"])
        return 0 <= sid < qm.shape[0] and bool(qm[sid])

    def route(self, model_stream, response_stream, prompt_len: int = 8):
        """Emissions of ``model_stream`` become LM requests; completions are
        posted as SUs on ``response_stream``."""
        sid = model_stream.sid if hasattr(model_stream, "sid") else int(model_stream)
        tenant = getattr(model_stream, "tenant", None)
        if tenant is None:
            tenant = self.engine.registry.stream_of(sid).tenant
        self.routes[sid] = _Route(sid, response_stream, prompt_len, tenant)

    # ------------------------------------------------- dynamic admission
    def admit_route(self, tenant, name: str, inputs, *,
                    channels=("req",), prompt_len: int = 8,
                    response_name: Optional[str] = None):
        """Admit a tenant's model-backed pipeline on the *running* engine:
        a model-backed composite subscribed to ``inputs`` plus its response
        stream, wired as a route — all through the admission plane's table
        edits, so serving tenants join mid-flight with zero recompilation.
        Returns ``(model_stream, response_stream)`` or ``None`` when the
        engine rejects for capacity (counted in
        ``engine.admission_rejected``)."""
        resp = self.engine.admit_stream(
            tenant, response_name or f"{name}.response", ["score"])
        if resp is None:
            return None
        model = self.engine.admit_composite(
            tenant, name, list(channels), inputs, model_backed=True)
        if model is None:
            self.engine.revoke_stream(resp)
            return None
        self.route(model, resp, prompt_len)
        return model, resp

    def revoke_route(self, model_stream) -> None:
        """Tear a model-backed pipeline down mid-flight: unregister the
        route and revoke both streams (queued requests drop into the
        engine's ``dropped_revoked`` counter; in-flight batcher requests
        complete but their completions land on a revoked row and are
        likewise dropped)."""
        sid = model_stream.sid if hasattr(model_stream, "sid") \
            else int(model_stream)
        r = self.routes.pop(sid, None)
        self.engine.revoke_stream(sid)
        if r is not None:
            self.engine.revoke_stream(r.response_stream)

    # ------------------------------------------------------------------
    def _tokenize(self, values: np.ndarray, n: int) -> List[int]:
        """Frontend stub: quantize channel values into token space."""
        v = self.batcher.cfg.vocab
        q = (np.abs(values) * 997).astype(np.int64) % max(v - 2, 1) + 1
        reps = -(-n // max(len(q), 1))
        return list(np.tile(q, reps)[:n])

    def pump(self, sink: SinkBatch, ts: int) -> int:
        """Scan one round's sink for model-backed emissions -> requests."""
        self._refresh_backpressure()
        sid, vals, valid, its = (_host(f) for f in (
            sink.sid, sink.vals, sink.valid, sink.its))
        n = 0
        for i in range(sid.shape[0]):
            if not valid[i]:
                continue
            n += self._submit(int(sid[i]), vals[i], int(its[i]))
        return n

    def pump_spool(self, spool: SinkSpool, ts: int) -> int:
        """Scan a whole superstep's sink spool (one readback for K rounds)
        for model-backed emissions — the superstep-plane counterpart of
        per-round :meth:`pump`.  Handles both the single-device spool and
        the per-shard stacked spool of the sharded engine; submissions run
        round-major (round, then shard, then emission order) so request
        ids match the per-round pump path exactly."""
        self._refresh_backpressure()
        sid, vals, its, rnd, fill = (_host(f) for f in (
            spool.sid, spool.vals, spool.its, spool.rnd, spool.fill))
        if sid.ndim == 1:                      # single device
            sid, vals, rnd, fill = sid[None], vals[None], rnd[None], fill[None]
            its = its[None]
        entries = sorted((int(rnd[s, i]), s, i)
                         for s in range(sid.shape[0])
                         for i in range(int(fill[s])))
        n = 0
        for _k, s, i in entries:
            n += self._submit(int(sid[s, i]), vals[s, i], int(its[s, i]))
        return n

    def _submit(self, sid: int, vals: np.ndarray,
                its: Optional[int] = None) -> int:
        r = self.routes.get(sid)
        if r is None:
            return 0
        if self._quarantined(sid):         # breaker tripped on the source
            self.dropped_quarantined += 1
            return 0
        if self._throttled(r.tenant):      # pump slowed: hold host-side
            self.deferred.append((sid, np.asarray(vals), its))
            return 0
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=self._tokenize(vals, r.prompt_len),
                      max_tokens=4, tenant=r.tenant)
        self.batcher.submit(req)
        self.inflight[rid] = r
        self._rid_its[rid] = its
        return 1

    def release_deferred(self) -> int:
        """Re-try emissions deferred by backpressure; those whose tenant is
        still over the watermark re-defer, while revoked routes and
        sources quarantined since the deferral drop (the latter counted in
        ``dropped_quarantined``; one ``fault_counters`` readback covers the
        whole burst).  Returns the number actually submitted."""
        self._refresh_backpressure()
        pending, self.deferred = self.deferred, []
        n = 0
        for sid, vals, its in pending:
            if sid in self.routes:
                n += self._submit(sid, vals, its)
        return n

    def serve(self, ts: int, K: Optional[int] = None,
              max_rounds: int = 256) -> int:
        """One serving step: drain the engine's backlog (in supersteps of
        ``K`` rounds when K > 1, pumping each spool; per-round sinks at
        K <= 1), submit the model-backed emissions, then drain the batcher
        so completions re-enter the engine as SUs.  Both paths process the
        whole backlog up to ``max_rounds``; K only sets how many rounds
        share one dispatch.  Emissions deferred by backpressure are
        re-tried first (draining lowers occupancy, so watermarked tenants
        resume here).  Returns the number of requests submitted."""
        K = K or self.engine.cfg.superstep
        n = self.release_deferred()
        if K <= 1:
            n += sum(self.pump(sink, ts)
                     for sink in self.engine.drain(max_rounds))
        else:
            n += sum(self.pump_spool(spool, ts) for spool in
                     self.engine.drain_spools(K, max_rounds))
        self.drain(ts=ts)
        return n

    # --------------------------------------------------------- elasticity
    def rebind(self, engine: StreamEngine) -> None:
        """Point the bridge at a different engine *object* (a
        ``restore_engine`` product; never needed after ``resize``, which
        morphs the engine in place).  Routes are re-resolved against the
        new engine's registry — routes whose streams no longer exist are
        dropped, exactly like :meth:`restore` — and the backpressure
        snapshot is invalidated."""
        self.engine = engine
        streams = engine.registry.streams
        self.routes = {
            sid: dataclasses.replace(
                r, response_stream=streams[self._sid_of(r.response_stream)])
            for sid, r in self.routes.items()
            if sid < len(streams) and streams[sid] is not None
            and streams[self._sid_of(r.response_stream)] is not None}
        self._occ = None
        self._qmask = None

    # ------------------------------------------------- durability & replay
    def snapshot(self) -> Dict:
        """JSON-able bridge control state for the durability plane: the
        route table, the request-id cursor and the backpressure-deferred
        emissions.  In-flight batcher requests are deliberately *not*
        captured — the bridge is at-most-once across a crash (completions
        of requests in flight at snapshot time are lost), while the engine
        underneath stays exactly-once on its own state.  Pair with the
        engine snapshot taken at the same boundary."""
        return {
            "routes": [[sid, int(self._sid_of(r.response_stream)),
                        r.prompt_len, r.tenant]
                       for sid, r in sorted(self.routes.items())],
            "next_rid": self._next_rid,
            "deferred": [[int(sid), np.asarray(vals).tolist(),
                          None if its is None else int(its)]
                         for sid, vals, its in self.deferred],
        }

    def restore(self, snap: Dict) -> None:
        """Rebuild routes/cursor/deferred from :meth:`snapshot` against a
        restored engine (``self.engine``'s registry resolves the response
        streams); routes whose streams were revoked since are dropped."""
        self.routes = {}
        streams = self.engine.registry.streams
        for sid, resp_sid, prompt_len, tenant in snap["routes"]:
            if sid < len(streams) and streams[sid] is not None \
                    and streams[resp_sid] is not None:
                self.routes[sid] = _Route(sid, streams[resp_sid],
                                          prompt_len, tenant)
        self._next_rid = int(snap["next_rid"])
        # pre-its snapshots carry [sid, vals] pairs: default the stamp
        self.deferred = [(int(e[0]), np.asarray(e[1], np.float32),
                          None if len(e) < 3 or e[2] is None else int(e[2]))
                         for e in snap["deferred"]]
        self.inflight = {}
        self._rid_its = {}
        self._occ = None
        self._qmask = None

    @staticmethod
    def _sid_of(stream) -> int:
        """Accept a registry Stream or a bare sid."""
        return stream.sid if hasattr(stream, "sid") else int(stream)

    def drain(self, max_ticks: int = 1000, ts: int = 0) -> List[Request]:
        """Run the batcher to completion (one ``run_ticks`` burst — it
        stops by itself when nothing is queued or live); post completions
        back into the engine as SUs."""
        self._refresh_backpressure()
        done = []
        for req in self.batcher.run_ticks(max_ticks):
            r = self.inflight.pop(req.rid)
            score = float(np.mean(req.output)) / self.batcher.cfg.vocab
            # the response SU keeps the request's ingest stamp, so the
            # end-to-end latency of a PRED pipeline includes serving time
            self.engine.post(r.response_stream, [score], ts=ts + req.rid + 1,
                             its=self._rid_its.pop(req.rid, None))
            done.append(req)
        self.completed += done
        return done
