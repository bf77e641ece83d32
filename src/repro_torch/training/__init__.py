"""Training substrate (port of ``repro.training``): optimizer, train step,
checkpointing, data pipeline."""
from . import checkpoint, data, optimizer, train_step

__all__ = ["checkpoint", "data", "optimizer", "train_step"]
