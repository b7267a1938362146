"""Optimizers and schedules of the port: MADGRAD / MirrorMADGRAD, NGD
and SGD with the reference's schedule pairings."""

from faster_distributed_training_tpu_torch.optim.builder import (  # noqa: F401
    Optimizer, build_optimizer, clip_by_global_norm, global_norm)
from faster_distributed_training_tpu_torch.optim.madgrad import (  # noqa: F401
    Madgrad, madgrad, mirror_madgrad)
from faster_distributed_training_tpu_torch.optim.ngd import (  # noqa: F401
    NGD, NGDHyperParams, ScaleByNGD, layouts_of)
