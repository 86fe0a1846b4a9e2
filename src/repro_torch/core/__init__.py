"""Core of the PyTorch port: the single-device multi-tenant pub/sub
stream round and its superstep plane (the names of the JAX package's
``repro.core`` that this package has ported)."""
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import (DLQ_REASONS, DeadLetter, DeviceTables,
                                     EngineState, IngestBatch, IngestRing,
                                     SinkBatch, SinkSpool, StreamEngine,
                                     create_engine, engine_from_snapshot,
                                     init_state, make_step, make_superstep,
                                     restore_engine)
from repro_torch.core.graph import PipelineGraph
from repro_torch.core.registry import Registry, Stream, Tenant

__all__ = [
    "EngineConfig", "Registry", "Stream", "Tenant", "StreamEngine",
    "DeviceTables", "EngineState", "IngestBatch", "SinkBatch",
    "IngestRing", "SinkSpool", "init_state", "make_step", "make_superstep",
    "create_engine", "engine_from_snapshot", "restore_engine", "DeadLetter",
    "DLQ_REASONS",
    "PipelineGraph",
]
