"""Launch-side control loops of the PyTorch port: the elastic plane's
autoscaler (``repro_torch.launch.autoscale``), the chaos-injection
harness (``repro_torch.launch.chaos``), the self-healing supervisor
(``repro_torch.launch.supervise``) and the training launcher's ``main``
(``repro_torch.launch.train``, exported as ``train_main`` on first use,
so that ``python -m repro_torch.launch.train`` does not find its own
module imported by the package)."""
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
           "Incident", "SuperviseReport", "Supervisor", "supervised_run",
           "train_main"]


def __getattr__(name):
    if name == "train_main":
        from repro_torch.launch.train import main
        return main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
