"""Model zoo of the port: the Transformer encoder so far (ResNet comes
with its own slice)."""

from faster_distributed_training_tpu_torch.models.transformer import (  # noqa: F401
    Transformer)


def get_model(name: str, num_classes: int, **kw):
    """Factory with the JAX package's signature."""
    if name == "transformer":
        return Transformer(n_class=num_classes, **kw)
    raise ValueError(f"unknown model {name!r}; the port has "
                     f"['transformer'] so far")
