"""Multi-tenant registry of Service Objects, streams and subscriptions.

This is the host-side control plane — the analogue of ServIoTicy's REST API
(§II-1) plus the Couchbase documents describing Service Objects.  It owns:

  * tenants (multi-tenancy: every stream belongs to a tenant; provenance of
    every emission is attributable to the owning tenant),
  * Service Objects grouping streams,
  * simple streams (device-fed) and composite streams (user code + inputs),
  * the compilation of user code (paper Listing 1) into VM bytecode,
  * the lowering of the whole subscription graph into the dense device
    tables consumed by the static engine program.

Everything the engine needs at runtime is produced by :meth:`build_tables`;
re-running it after pipeline changes yields new *data* for the same compiled
engine — user-code injection without recompilation (§IV-F).

For *live* churn the registry doubles as the host mirror of the dynamic
admission plane (``repro.core.admission`` in the JAX package): :meth:`with_capacity` builds
a capacity-padded registry whose tables carry an ``active`` row mask,
:meth:`remove_stream` / :meth:`unsubscribe` release rows and edges, and
released sids are recycled (lowest first) by the next admission — so the
on-device table edits and a from-scratch :meth:`build_tables` of the same
final topology produce bit-identical images.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import program as pvm
from repro_torch.core.config import EngineConfig


class CapacityError(ValueError):
    """A table/quota capacity limit rejected the operation.  The admission
    plane counts these (``admission_rejected``) and reports ``None``/
    ``False``; genuine validation errors (bad user code, unknown channel)
    stay ordinary exceptions and propagate."""


@dataclasses.dataclass
class Tenant:
    """A platform tenant: the unit of ownership, accounting (per-tenant
    emission/drop counters) and QoS (fair-share weight, ingest quota —
    both live in the engine's device tables, set via
    ``StreamEngine.set_weight`` / ``set_quota``).  ``quota_streams`` is
    the *control-plane* cap on how many streams the tenant may own."""
    tid: int
    name: str
    quota_streams: int = 1_000_000


@dataclasses.dataclass
class Stream:
    """One data stream: ``sid`` indexes every engine table/state row.
    Simple streams are device-fed via ingest; composite streams subscribe
    to ``inputs`` and run user ``transform`` code per triggering SU."""
    sid: int
    tenant: int
    name: str
    channels: List[str]                      # channel names, len <= cfg.channels
    composite: bool = False
    inputs: List[int] = dataclasses.field(default_factory=list)
    # slot -> [name, channels] of a revoked input (slot kept as -1 so the
    # remaining `in<i>` bindings — and stale expressions — stay stable,
    # mirroring the device tables, which null edges in place):
    dead_inputs: Dict[str, List] = dataclasses.field(default_factory=dict)
    # user code (expression strings), per output channel:
    transform: Dict[str, str] = dataclasses.field(default_factory=dict)
    pre_filter: Optional[str] = None
    post_filter: Optional[str] = None
    model_backed: bool = False               # serviced by the model plane
    service_object: Optional[str] = None


@dataclasses.dataclass
class EngineTables:
    """Dense device-table images (numpy; moved to device by the engine).
    Per-stream rows are (N, ...); the trailing three are the per-tenant
    QoS tables, (n_tenants,), lowered at zero (QoS off) and edited live
    through ``StreamEngine.set_weight`` / ``set_quota``."""
    in_table: np.ndarray       # (N, M) int32, input stream ids, -1 pad
    in_count: np.ndarray       # (N,) int32
    out_table: np.ndarray      # (N, F) int32, subscriber ids, -1 pad
    out_count: np.ndarray      # (N,) int32
    progs: np.ndarray          # (N, L, 4) int32
    consts: np.ndarray         # (N, K) float32
    is_composite: np.ndarray   # (N,) bool
    tenant: np.ndarray         # (N,) int32
    priority: np.ndarray       # (N,) int32  (lower = served first)
    n_channels: np.ndarray     # (N,) int32
    model_backed: np.ndarray   # (N,) bool
    active: np.ndarray         # (N,) bool — live rows; spare capacity is False
    weight: np.ndarray         # (T,) int32 fair-share weight, 0 = unshaped
    quota: np.ndarray          # (T,) int32 ingest tokens/round, 0 = no cap
    burst: np.ndarray          # (T,) int32 token-bucket capacity
    breaker: np.ndarray        # (3,) int32 circuit breaker [W, F, amp_ceil];
    #                            F == 0 disarms tripping, ceil == 0 disarms
    #                            amplification detection.  Runtime data like
    #                            the QoS tables: edited live via
    #                            ``StreamEngine.set_breaker``.


class Registry:
    """The host-side control plane (paper §II-1): owns tenants, streams
    and subscriptions, compiles user code to VM bytecode, and lowers the
    whole graph into the dense :class:`EngineTables` the compiled engine
    consumes — plus the host mirror of live churn (sid recycling,
    capacity pre-checks) for the admission plane."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg.validate()
        self.tenants: List[Tenant] = []
        # indexed by sid; revoked sids leave ``None`` holes until readmission
        self.streams: List[Optional[Stream]] = []
        self._free_sids: List[int] = []          # released sids, sorted

    @classmethod
    def with_capacity(cls, cfg: EngineConfig, max_streams: int = None,
                      max_subs: int = None) -> "Registry":
        """A registry whose engine tables are padded to ``max_streams`` rows
        and ``max_subs`` subscription slots per direction.  The spare rows
        carry ``active=False`` and are filled *live* by the admission plane
        — the engine compiled against this config never retraces as tenants
        come and go."""
        return cls(cfg.padded(max_streams, max_subs))

    # ------------------------------------------------------------- tenants
    def create_tenant(self, name: str, quota_streams: int = 1_000_000) -> Tenant:
        """Register a new tenant (capped by ``cfg.n_tenants``); its tid
        indexes every per-tenant engine counter and QoS table."""
        if len(self.tenants) >= self.cfg.n_tenants:
            raise CapacityError("tenant capacity exhausted")
        t = Tenant(len(self.tenants), name, quota_streams)
        self.tenants.append(t)
        return t

    # ------------------------------------------------------------- streams
    def _alloc_sid(self, tenant: Tenant) -> int:
        if not self._free_sids and len(self.streams) >= self.cfg.n_streams:
            raise CapacityError("stream capacity exhausted")
        owned = sum(1 for s in self.streams
                    if s is not None and s.tenant == tenant.tid)
        if owned >= tenant.quota_streams:
            raise CapacityError(f"tenant {tenant.name} exceeded stream quota")
        # recycle released sids lowest-first so revoke-then-readmit lands on
        # the same row (deterministic table images)
        if self._free_sids:
            return self._free_sids[0]
        return len(self.streams)

    def _install(self, s: Stream) -> Stream:
        if s.sid == len(self.streams):
            self.streams.append(s)
        else:
            assert self.streams[s.sid] is None
            self._free_sids.remove(s.sid)
            self.streams[s.sid] = s
        return s

    def stream_of(self, sid: int) -> Stream:
        """The live :class:`Stream` occupying ``sid`` (raises on a revoked
        or never-allocated row)."""
        s = self.streams[sid]
        if s is None:
            raise ValueError(f"sid {sid} is revoked")
        return s

    @property
    def n_active(self) -> int:
        """Number of live (non-revoked) streams across all tenants."""
        return sum(1 for s in self.streams if s is not None)

    def create_stream(
        self, tenant: Tenant, name: str, channels: Sequence[str],
        service_object: Optional[str] = None,
    ) -> Stream:
        """A *simple* stream: fed by a device (Web Object) via ingest."""
        if len(channels) > self.cfg.channels:
            raise ValueError("too many channels")
        s = Stream(self._alloc_sid(tenant), tenant.tid, name, list(channels),
                   service_object=service_object)
        return self._install(s)

    def create_composite(
        self, tenant: Tenant, name: str, channels: Sequence[str],
        inputs: Sequence[Stream],
        transform: Dict[str, str],
        pre_filter: Optional[str] = None,
        post_filter: Optional[str] = None,
        service_object: Optional[str] = None,
        model_backed: bool = False,
    ) -> Stream:
        """A *composite* stream (paper §IV): subscribes to ``inputs`` and
        runs user ``transform`` code on every triggering Sensor Update.

        Subscriptions may cross tenants — that is the paper's headline
        multi-tenancy: tenants share data streams between them.
        """
        if len(inputs) > self.cfg.max_in:
            raise CapacityError(f"in-degree {len(inputs)} > max_in {self.cfg.max_in}")
        if len(channels) > self.cfg.channels:
            raise ValueError("too many channels")
        for ch in channels:
            if ch not in transform and not model_backed:
                raise ValueError(f"no transform for channel {ch!r}")
        for i in inputs:
            self._check_live(i)
        # fan-out capacity pre-check on the sources (before installing, so a
        # rejected admission leaves the registry untouched)
        for src in {i.sid: i for i in inputs}.values():
            subs = sum(1 for t in self.streams
                       if t is not None and t.composite and src.sid in t.inputs)
            if subs + 1 > self.cfg.max_out:
                raise CapacityError(
                    f"out-degree of {src.name} exceeds max_out {self.cfg.max_out}")
        s = Stream(self._alloc_sid(tenant), tenant.tid, name, list(channels),
                   composite=True, inputs=[i.sid for i in inputs],
                   transform=dict(transform), pre_filter=pre_filter,
                   post_filter=post_filter, service_object=service_object,
                   model_backed=model_backed)
        return self._install(s)

    def _check_live(self, stream: Stream) -> None:
        """The exact Stream object must still occupy its sid (identity, not
        equality: a recycled sid belongs to a different stream)."""
        if self.streams[stream.sid] is not stream:
            raise ValueError(f"stream {stream.name!r} (sid {stream.sid}) "
                             "is revoked")

    def subscribe(self, stream: Stream, new_input: Stream) -> None:
        """Dynamically rewire: add a subscription to an existing composite."""
        if not stream.composite:
            raise ValueError("can only subscribe composite streams")
        self._check_live(stream)
        self._check_live(new_input)
        free = [i for i, x in enumerate(stream.inputs) if x < 0]
        if not free and len(stream.inputs) >= self.cfg.max_in:
            raise CapacityError("in-degree capacity reached")
        subs = sum(1 for t in self.streams
                   if t is not None and t.composite and new_input.sid in t.inputs)
        if new_input.sid not in stream.inputs and subs + 1 > self.cfg.max_out:
            raise CapacityError(
                f"out-degree of {new_input.name} exceeds max_out "
                f"{self.cfg.max_out}")
        if free:            # device writes into the first -1 slot: mirror it
            stream.inputs[free[0]] = new_input.sid
            stream.dead_inputs.pop(str(free[0]), None)
        else:
            stream.inputs.append(new_input.sid)

    def unsubscribe(self, stream: Stream, old_input: Stream) -> None:
        """Remove one subscription edge (the host mirror of
        the admission plane's ``revoke_subscription``)."""
        if old_input.sid not in stream.inputs:
            raise ValueError(
                f"{stream.name} does not subscribe to {old_input.name}")
        i = stream.inputs.index(old_input.sid)   # first occurrence, as device
        stream.inputs[i] = -1
        stream.dead_inputs[str(i)] = [old_input.name,
                                      list(old_input.channels)]

    def remove_stream(self, stream) -> None:
        """Release a stream's sid: every subscription edge referencing it is
        severed (subscribers keep running on their remaining inputs) and the
        sid is recycled by the next admission.  Host mirror of
        the admission plane's ``revoke_stream``."""
        sid = stream.sid if hasattr(stream, "sid") else int(stream)
        src = self.streams[sid]
        if src is None:
            raise ValueError(f"sid {sid} already revoked")
        for t in self.streams:
            if t is not None and t.composite and sid in t.inputs:
                for j, i in enumerate(t.inputs):  # null in place, as device
                    if i == sid:
                        t.inputs[j] = -1
                        t.dead_inputs[str(j)] = [src.name, list(src.channels)]
        self.streams[sid] = None
        bisect.insort(self._free_sids, sid)

    # ---------------------------------------------------------- code->VM
    def _env_for(self, s: Stream) -> Dict[str, int]:
        """Identifier environment for stream ``s``'s expressions.

        ``in<i>.<ch>`` / ``<src_name>.<ch>`` — input slot values,
        ``prev.<ch>`` — previous self value, ``out.<ch>`` — result channels
        (post-filter only), ``ts`` / ``trigger`` — metadata registers.
        """
        cfg = self.cfg
        env: Dict[str, int] = {"ts": cfg.reg_ts, "trigger": cfg.reg_trigger}
        for i, sid in enumerate(s.inputs):
            if sid >= 0:
                src = self.streams[sid]
                name, channels = src.name, src.channels
            elif str(i) in s.dead_inputs:   # tombstone: revoked input — the
                name, channels = s.dead_inputs[str(i)]  # slot's stale
            else:                           # expressions must still compile
                continue
            for c, ch in enumerate(channels):
                reg = cfg.reg_inputs + i * cfg.channels + c
                env[f"in{i}.{ch}"] = reg
                env.setdefault(f"{name}.{ch}", reg)
            env[f"in{i}"] = cfg.reg_inputs + i * cfg.channels  # 1-channel shorthand
            env.setdefault(name, cfg.reg_inputs + i * cfg.channels)
        for c, ch in enumerate(s.channels):
            env[f"prev.{ch}"] = cfg.reg_prev + c
            env[f"out.{ch}"] = cfg.reg_result + c
        env["prev"] = cfg.reg_prev
        return env

    def _compile_stream(self, s: Stream) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        env = self._env_for(s)
        code: List[Tuple[int, int, int, int]] = []
        consts: List[float] = [1.0]

        def add(expr: str, result_reg: int):
            c, k = pvm.compile_expr(
                expr, env, result_reg=result_reg,
                tmp_base=cfg.reg_tmp, tmp_count=cfg.n_temps)
            # remap constant-pool indices into the shared pool
            remap = {}
            for j, v in enumerate(k):
                if v in consts:
                    remap[j] = consts.index(v)
                else:
                    remap[j] = len(consts)
                    consts.append(v)
            for (op, d, a, b) in c:
                if op == pvm.OP_CONST:
                    a = remap[a]
                code.append((op, d, a, b))

        if s.pre_filter:
            add(s.pre_filter, cfg.reg_pref)
        else:
            code.append((pvm.OP_CONST, cfg.reg_pref, 0, 0))   # consts[0] == 1.0
        for c, ch in enumerate(s.channels):
            if s.model_backed:
                # placeholder passthrough; real output supplied by model plane
                code.append((pvm.OP_MOV, cfg.reg_result + c, cfg.reg_inputs + c, 0))
            else:
                add(s.transform[ch], cfg.reg_result + c)
        if s.post_filter:
            add(s.post_filter, cfg.reg_postf)
        else:
            code.append((pvm.OP_CONST, cfg.reg_postf, 0, 0))
        return pvm.assemble(code, consts, cfg.prog_len, cfg.n_consts)

    # ---------------------------------------------------------- lowering
    def build_tables(self, priority: Optional[np.ndarray] = None) -> EngineTables:
        """Lower the whole subscription graph into dense
        :class:`EngineTables` images — same shapes for any topology that
        fits the capacities, so re-lowering after pipeline changes feeds
        the *same* compiled engine new data and never retraces.  The QoS
        tables lower at zero (shaping off); ``priority`` is the optional
        (n_streams,) per-sid pop priority (lower = served first)."""
        cfg, N = self.cfg, self.cfg.n_streams
        in_table = np.full((N, cfg.max_in), -1, np.int32)
        in_count = np.zeros((N,), np.int32)
        out_lists: List[List[int]] = [[] for _ in range(N)]
        progs = np.zeros((N, cfg.prog_len, 4), np.int32)
        consts = np.zeros((N, cfg.n_consts), np.float32)
        is_comp = np.zeros((N,), bool)
        tenant = np.zeros((N,), np.int32)
        n_ch = np.ones((N,), np.int32)
        model_backed = np.zeros((N,), bool)
        active = np.zeros((N,), bool)

        for s in self.streams:
            if s is None:
                continue
            active[s.sid] = True
            tenant[s.sid] = s.tenant
            n_ch[s.sid] = len(s.channels)
            model_backed[s.sid] = s.model_backed
            if s.composite:
                is_comp[s.sid] = True
                in_count[s.sid] = sum(1 for i in s.inputs if i >= 0)
                in_table[s.sid, : len(s.inputs)] = s.inputs  # -1 == pad
                for src in s.inputs:
                    if src < 0:             # tombstoned (revoked) slot
                        continue
                    if s.sid not in out_lists[src]:
                        out_lists[src].append(s.sid)
                progs[s.sid], consts[s.sid] = self._compile_stream(s)

        out_table = np.full((N, cfg.max_out), -1, np.int32)
        out_count = np.zeros((N,), np.int32)
        for sid, lst in enumerate(out_lists):
            if len(lst) > cfg.max_out:
                raise ValueError(f"stream {sid} out-degree {len(lst)} > {cfg.max_out}")
            out_count[sid] = len(lst)
            out_table[sid, : len(lst)] = lst

        if priority is None:
            priority = np.zeros((N,), np.int32)
        T = cfg.n_tenants
        return EngineTables(
            in_table=in_table, in_count=in_count,
            out_table=out_table, out_count=out_count,
            progs=progs, consts=consts, is_composite=is_comp,
            tenant=tenant, priority=np.asarray(priority, np.int32),
            n_channels=n_ch, model_backed=model_backed, active=active,
            weight=np.zeros((T,), np.int32),
            quota=np.zeros((T,), np.int32),
            burst=np.zeros((T,), np.int32),
            breaker=np.array([self.cfg.fault_window,
                              self.cfg.fault_threshold,
                              self.cfg.fault_amp_ceiling], np.int32),
        )

    # ---------------------------------------------------------- durability
    def to_snapshot(self) -> Dict:
        """JSON-able mirror of the whole control plane — config, tenants,
        streams (holes included) and the recycled-sid pool — the host half
        of an engine checkpoint.  :meth:`from_snapshot` reverses it
        exactly, so a restored engine recompiles identical bytecode and
        recycles sids in the same order."""
        return {
            "cfg": dataclasses.asdict(self.cfg),
            "tenants": [dataclasses.asdict(t) for t in self.tenants],
            "streams": [None if s is None else dataclasses.asdict(s)
                        for s in self.streams],
            "free_sids": list(self._free_sids),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict) -> "Registry":
        """Rebuild the registry captured by :meth:`to_snapshot`."""
        reg = cls(EngineConfig(**snap["cfg"]))
        reg.tenants = [Tenant(**t) for t in snap["tenants"]]
        reg.streams = [None if s is None else Stream(**s)
                       for s in snap["streams"]]
        reg._free_sids = list(snap["free_sids"])
        return reg

    def build_sharded_tables(
        self, priority: Optional[np.ndarray] = None,
        n_shards: Optional[int] = None, partition: Optional[str] = None,
    ):
        """Lower the graph for the sharded engine: shard-local table slices
        stacked on a leading ``(n_shards,)`` axis plus the
        :class:`~repro_torch.distributed.stream_sharding.ShardPlan` holding
        the global ``sid -> shard`` map.  Returns ``(tables, plan)``."""
        from repro_torch.distributed.stream_sharding import (plan_partition,
                                                             shard_tables)
        flat = self.build_tables(priority)
        plan = plan_partition(self.cfg, flat.tenant,
                              n_shards=n_shards, partition=partition)
        return shard_tables(flat, plan), plan
