"""PyTorch/CUDA port of faster_distributed_training_tpu for NVIDIA Hopper.

A second implementation beside the JAX package, which stays the
reference.  It imports torch and never jax, nor anything of the JAX
package.  Entry points run on CUDA unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``); on the CPU every kernel wrapper
runs its plain PyTorch version.  Slice 1 covers classifier serving
(``cli.run_serving`` / ``cli.main_serve``); slice 2 the transformer's
one-card training step and K=1 loop with checkpoint and resume
(``cli.run_training`` / ``cli.main``, ``python -m
faster_distributed_training_tpu_torch.transformer_test``).
"""
