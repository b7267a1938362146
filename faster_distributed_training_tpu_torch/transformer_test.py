"""Transformer text-classification training entry of the port: the twin
of the JAX package's ``transformer_test.py`` (same record and flags).

    python -m faster_distributed_training_tpu_torch.transformer_test \\
        --dataset synthetic --epoch 1

Runs on CUDA by default; ``--device cpu`` runs the kernels' plain
versions on the CPU.  Flags of features the port has not reached raise
NotImplementedError naming the flag.
"""

from faster_distributed_training_tpu_torch.cli import TRANSFORMER_DEFAULTS, main

DEFAULTS = TRANSFORMER_DEFAULTS

if __name__ == "__main__":
    import torch.distributed as dist

    result = main(defaults=DEFAULTS, prog="transformer_test")
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"best test accuracy: {result['best_acc']:.4f}")
