"""Launch-side control loops of the PyTorch port: the elastic plane's
autoscaler (``repro_torch.launch.autoscale``)."""
from repro_torch.launch.autoscale import Autoscaler, ScaleEvent, autoscaled_run

__all__ = ["Autoscaler", "ScaleEvent", "autoscaled_run"]
