"""Auxiliary subsystems: checkpoint and resume, structured metrics, finite
checks and profiling annotations. Counterpart of `psgd_tf_tpu/utils/`."""
from psgd_tf_tpu_torch.utils import checkpoint, checks, metrics, profiling

__all__ = ["checkpoint", "checks", "metrics", "profiling"]
