"""Training of the port: losses, mixup, the bf16 policy, the train state,
the train/eval steps, checkpoints and the K=1 Trainer loop."""
