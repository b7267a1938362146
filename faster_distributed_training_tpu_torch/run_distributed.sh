#!/usr/bin/env bash
# Data-parallel launch of the port's two entry points under torchrun, one
# process a card (the twin of the repository's root run_distributed.sh).
#
# Every process joins the NCCL group from torchrun's RANK / WORLD_SIZE /
# LOCAL_RANK / MASTER_ADDR / MASTER_PORT (--distributed) and trains on its
# rows of each global batch (--bs is the global batch).  Extra arguments
# go to both entries, e.g. a fully-sharded run with the host tiers:
#   NPROC=4 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --fsdp --host_offload --offload_opt_state
# (--ngd, which the ResNet entry takes, cannot be combined with --fsdp or
# --zero1; NGD on the transformer is not ported, so its line has none).
# On the CPU: NPROC=2 ... --device cpu (gloo).
#
# Tensor, sequence and pipeline parallelism train the transformer only:
# TP=1, SP=1 or PP=1 runs just its line, the ranks laid out dp-outer and the model axis
# inner, e.g. two data ranks of two tp ranks each (--mesh's product must
# equal NPROC):
#   TP=1 NPROC=4 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --mesh dp=2,tp=2
# and on the CPU at a tiny width:
#   TP=1 NPROC=2 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --mesh tp=2 --device cpu --dataset synthetic --epoch 1 --n_layers 2 \
#     --d_model 64 --n_heads 4 --d_ff 128 --seq_len 64 --subset_stride 32 \
#     --bs 16
# Sequence parallelism splits each row's positions over an sp group (ring
# or Ulysses attention; --attention picks, else Ulysses where sp divides
# the heads), e.g. the next-token LM at seq 8192 on two cards:
#   SP=1 NPROC=2 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --mesh sp=2 --task lm --dataset stream --stream_dir D --bs 4
# and on the CPU, two data ranks of two sp ranks at a tiny width:
#   SP=1 NPROC=4 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --mesh dp=2,sp=2 --device cpu --dataset synthetic --epoch 1 \
#     --n_layers 2 --d_model 64 --n_heads 4 --d_ff 128 --seq_len 64 \
#     --subset_stride 32 --bs 16
# Pipeline parallelism stages the transformer's layers over the ranks of
# a pp group, one process a stage (PP=1 runs just its line; pp is laid
# out outermost), e.g. two stages of two data ranks, interleaved:
#   PP=1 NPROC=4 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --mesh dp=2,pp=2 --pp_schedule interleaved --pp_microbatches 8
# and on the CPU at a tiny width:
#   PP=1 NPROC=2 bash faster_distributed_training_tpu_torch/run_distributed.sh \
#     --mesh pp=2 --device cpu --dataset synthetic --epoch 1 --n_layers 2 \
#     --d_model 64 --n_heads 4 --d_ff 128 --seq_len 64 --subset_stride 32 \
#     --bs 16
set -euo pipefail

NPROC="${NPROC:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}"
RUN=(torchrun --standalone --nproc_per_node="${NPROC}" -m)

if [[ -z "${TP:-}${SP:-}${PP:-}" ]]; then
  "${RUN[@]}" faster_distributed_training_tpu_torch.resnet50_test \
    --distributed --bs 256 --lr 0.01 --meta_learning --ngd "$@"
fi
"${RUN[@]}" faster_distributed_training_tpu_torch.transformer_test \
  --distributed --bs 64 "$@"
