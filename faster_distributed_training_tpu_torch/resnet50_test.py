"""ResNet-50 / CIFAR-10 training entry of the port: the twin of the JAX
package's ``resnet50_test.py`` (same record and flags).

    python -m faster_distributed_training_tpu_torch.resnet50_test --ngd \\
        --meta_learning

Runs on CUDA by default; ``--device cpu`` runs on the CPU.  Without the
CIFAR-10 batches under ``--data_dir`` it trains on the synthetic
fallback.  Flags of features the port has not reached raise
NotImplementedError naming the flag.
"""

from faster_distributed_training_tpu_torch.cli import RESNET50_DEFAULTS, main

DEFAULTS = RESNET50_DEFAULTS

if __name__ == "__main__":
    import torch.distributed as dist

    result = main(defaults=DEFAULTS, prog="resnet50_test")
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"best test accuracy: {result['best_acc']:.4f}")
