"""Model zoo of the port: the Transformer encoder and the ResNet family
(resnet18 to resnet152)."""

from faster_distributed_training_tpu_torch.models.resnet import (  # noqa: F401
    RESNETS, ResNet)
from faster_distributed_training_tpu_torch.models.transformer import (  # noqa: F401
    Transformer)


def get_model(name: str, num_classes: int, **kw):
    """Factory with the JAX package's signature."""
    if name == "transformer":
        return Transformer(n_class=num_classes, **kw)
    if name in RESNETS:
        return RESNETS[name](num_classes=num_classes, **kw)
    raise ValueError(f"unknown model {name!r}; the port has "
                     f"{['transformer', *RESNETS]}")
