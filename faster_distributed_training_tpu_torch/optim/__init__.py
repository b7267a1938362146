"""Optimizers and schedules of the port: MADGRAD / MirrorMADGRAD with the
reference's schedule pairings (NGD comes with the ResNet slice)."""

from faster_distributed_training_tpu_torch.optim.builder import (  # noqa: F401
    Optimizer, build_optimizer, clip_by_global_norm, global_norm)
from faster_distributed_training_tpu_torch.optim.madgrad import (  # noqa: F401
    Madgrad, madgrad, mirror_madgrad)
