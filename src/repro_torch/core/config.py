"""Static configuration of the stream engine (a copy of the JAX package's
``repro.core.config``, kept here so the port imports nothing of it).

Everything here fixes the shape of a tensor the engine round reads or
writes (the analogue of the STORM topology's worker/executor counts).
Tenants' pipelines live entirely in device tensors sized by these
capacities, so creating, rewiring or destroying a pipeline is a table
edit and never changes a shape.  Every field is the JAX package's, so a
configuration round-trips unchanged between the two packages.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Compile-time capacities of one engine: array shapes of every table,
    state leaf and batch the jitted round is traced for.  Changing any
    field means a new compiled program; everything *within* these shapes
    (topologies, user code, QoS weights and quotas) is runtime data.
    Sizing and tuning guidance lives in docs/OPERATIONS.md."""
    n_streams: int = 256        # stream-id capacity (rows of the state table)
    n_tenants: int = 16
    channels: int = 4           # max channels per Sensor Update
    max_in: int = 16            # max in-degree (subscriptions per composite)
    max_out: int = 16           # max out-degree (subscribers per stream)
    batch: int = 64             # events popped per engine round
    queue: int = 2048           # pending-SU slots
    prog_len: int = 48          # bytecode instructions per stream program
    n_consts: int = 16          # constant-pool entries per stream
    n_temps: int = 16           # VM temporary registers
    sink_buffer: int = 256      # per-round external-emission buffer rows

    # ---- sharded stream plane ------
    n_shards: int = 1           # 1-D device mesh size for the pub/sub plane
    partition: str = "block"    # "block" (sid ranges) | "tenant" (hash)
    exchange_slots: int = 0     # per-destination exchange rows (0 -> work)

    # ---- superstep execution plane -------------
    superstep: int = 1          # rounds fused per compiled scan (1 = off)
    sink_spool_slots: int = 0   # per-superstep sink spool rows (0 -> K*sink)

    # ---- durability & replay plane (repro_torch.checkpoint, engine DLQ) --
    checkpoint_every: int = 0   # async snapshot every N supersteps (0 = off)
    retention_slots: int = 0    # retained emissions per stream (0 = off)
    dlq_slots: int = 0          # dead-letter spool rows (0 = off)

    # ---- fault-isolation plane (circuit breaker; docs/OPERATIONS.md) ---
    # Per-stream poison detection rides the round as runtime data: a fault
    # is a non-finite program output or a dispatch fanning out to more
    # than `fault_amp_ceiling` valid work items.  A stream accumulating
    # `fault_threshold` faults within a `fault_window`-round window trips
    # its breaker and is quarantined on device (active mask flipped,
    # queued SUs dead-lettered as `poisoned`).  These are *defaults*
    # lowered into the runtime breaker table — live edits go through
    # `StreamEngine.set_breaker` with zero retraces, so none of them is a
    # compile-time shape.  threshold 0 disables tripping (faults are
    # still counted); ceiling 0 disables amplification detection.
    fault_window: int = 8       # W: rounds a fault burst may span
    fault_threshold: int = 0    # F: faults within W that trip (0 = off)
    fault_amp_ceiling: int = 0  # max valid fan-out per dispatch (0 = off)

    # ---- scheduler hot path (engine._pop) ------------------------------
    # "packed": selection pop over packed key planes — O(queue*batch), the
    #           CUDA sched_pop kernel on the GPU, the plain torch ref on CPU.
    # "lexsort": the O(queue log queue) full-sort reference pop (the
    #           differential oracle).  Both are bit-identical.
    scheduler: str = "packed"

    # ---- fused round (repro_torch.kernels.round_fuse) ------------------------
    # Run stages 1-3 (pop, fan-out, fetch+VM, window gate) as one fused
    # operation — the CUDA fused_round kernel on the GPU, the plain torch
    # refs on the CPU.  Bit-identical to the staged round for fusable programs
    # (no transcendental opcodes); the engine checks fusability host-side
    # at every program edit and silently uses the staged path otherwise.
    # Requires scheduler == "packed" (the fused pop *is* the packed pop).
    fused_round: bool = True

    # ---- register file layout ------------------------------------------
    @property
    def reg_inputs(self) -> int:
        """First input register: slot i, channel c lands at ``i*C + c``."""
        return 0

    @property
    def reg_prev(self) -> int:
        """First of the C registers holding the stream's previous value."""
        return self.max_in * self.channels

    @property
    def reg_ts(self) -> int:
        """Register carrying the trigger SU's timestamp (as float32)."""
        return self.reg_prev + self.channels

    @property
    def reg_trigger(self) -> int:
        """Register carrying the triggering input-slot index (as f32)."""
        return self.reg_ts + 1

    @property
    def reg_result(self) -> int:
        """First of the C registers the transform writes its result to."""
        return self.reg_trigger + 1

    @property
    def reg_pref(self) -> int:
        """Pre-filter boolean register (nonzero = SU passes)."""
        return self.reg_result + self.channels

    @property
    def reg_postf(self) -> int:
        """Post-filter boolean register (nonzero = emission passes)."""
        return self.reg_pref + 1

    @property
    def reg_tmp(self) -> int:
        """First of the ``n_temps`` VM scratch registers."""
        return self.reg_postf + 1

    @property
    def n_regs(self) -> int:
        """Total register-file width per work item."""
        return self.reg_tmp + self.n_temps

    @property
    def work(self) -> int:
        """Work items per round: ``batch * max_out`` (stage-1 fan-out)."""
        return self.batch * self.max_out

    @property
    def exchange(self) -> int:
        """Effective per-destination exchange capacity.  The default
        (``work``) can never overflow even if one shard's whole fan-out
        targets a single destination — the precondition for bit-exact
        equivalence with the single-device engine — at the price of a
        post-exchange work width of n_shards*work per shard.  Throughput
        deployments should set ``exchange_slots`` near the expected
        per-destination traffic and watch ``stats["dropped_overflow"]``."""
        return self.exchange_slots if self.exchange_slots > 0 else self.work

    def spool_slots(self, K: int) -> int:
        """Sink-spool capacity of a K-round superstep.  The default
        (``K * sink_buffer``) can hold every per-round sink buffer in full,
        so the spool can never overflow — the precondition for bit-exact
        equivalence with K per-round sink readbacks.  Throughput
        deployments size ``sink_spool_slots`` near the expected emission
        rate and watch ``stats["dropped_spool"]``."""
        return self.sink_spool_slots if self.sink_spool_slots > 0 \
            else K * self.sink_buffer

    def ring_slots(self, K: int) -> int:
        """Ingest-ring capacity of a K-round superstep: room for the
        ``(K, batch)`` pre-staged grid plus a queue's worth of overflow
        SUs that persist on device between supersteps (same-stream bursts
        longer than K rounds).  Backlog beyond this stays host-side in
        ``_pending`` — never lost, just staged later."""
        return K * self.batch + self.queue

    def padded(self, max_streams: int = None, max_subs: int = None
               ) -> "EngineConfig":
        """Capacity-padded copy for the dynamic admission plane: room for
        ``max_streams`` stream rows and ``max_subs`` subscriptions per edge
        direction (in-degree and out-degree).  The engine compiled for the
        padded config admits/revokes tenants into the spare rows as pure
        table edits — never recompiling."""
        return dataclasses.replace(
            self,
            n_streams=max(self.n_streams, max_streams or 0),
            max_in=max(self.max_in, max_subs or 0),
            max_out=max(self.max_out, max_subs or 0),
        )

    def with_shards(self, n_shards: int,
                    partition: str = None) -> "EngineConfig":
        """Copy of this config at a different mesh size — the shape the
        elastic plane (``StreamEngine.resize``, the autoscaler, and
        cross-shard-count ``restore_engine``) moves between.  Everything
        but ``n_shards``/``partition`` is preserved, so every state leaf
        stays migratable (queues, retention rings and the DLQ keep their
        per-shard capacities)."""
        return dataclasses.replace(
            self, n_shards=int(n_shards),
            partition=partition or self.partition).validate()

    def validate(self) -> "EngineConfig":
        """Assert the capacity invariants the engine assumes; returns self
        so constructors can chain it."""
        assert self.n_streams >= 2 and self.channels >= 1
        assert self.max_in >= 1 and self.max_out >= 1
        assert self.queue >= self.batch
        assert self.n_shards >= 1
        assert self.partition in ("block", "tenant")
        assert self.superstep >= 1
        assert self.sink_spool_slots >= 0
        assert self.scheduler in ("packed", "lexsort")
        assert self.checkpoint_every >= 0
        assert self.fault_window >= 1
        assert self.fault_threshold >= 0
        assert self.fault_amp_ceiling >= 0
        assert self.retention_slots >= 0
        assert self.dlq_slots >= 0
        return self
