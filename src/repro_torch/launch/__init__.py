"""Launch-side control loops of the PyTorch port: the elastic plane's
autoscaler (``repro_torch.launch.autoscale``), the chaos-injection
harness (``repro_torch.launch.chaos``) and the self-healing supervisor
(``repro_torch.launch.supervise``)."""
from repro_torch.launch.autoscale import Autoscaler, ScaleEvent, autoscaled_run
from repro_torch.launch.chaos import (POISON_KINDS, ChaosEvent, ChaosMonkey,
                                      ShardKill, corrupt_checkpoint,
                                      hostile_transform,
                                      inject_hostile_program,
                                      inject_ingest_storm,
                                      inject_payload_corruption,
                                      poison_payload)
from repro_torch.launch.supervise import (Incident, SuperviseReport,
                                          Supervisor, supervised_run)

__all__ = ["Autoscaler", "ScaleEvent", "autoscaled_run",
           "POISON_KINDS", "ChaosEvent", "ChaosMonkey", "ShardKill",
           "corrupt_checkpoint", "hostile_transform",
           "inject_hostile_program", "inject_ingest_storm",
           "inject_payload_corruption", "poison_payload",
           "Incident", "SuperviseReport", "Supervisor", "supervised_run"]
