from repro_torch.data.pipeline import SensorUpdateGenerator, SyntheticCorpus

__all__ = ["SyntheticCorpus", "SensorUpdateGenerator"]
