"""The serving plane of the port (``repro.serving``): the continuous
batching decode server and the model-backed-streams bridge between the
engine and the model plane."""
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.bridge import ModelBackedStreams

__all__ = ["ContinuousBatcher", "Request", "ModelBackedStreams"]
