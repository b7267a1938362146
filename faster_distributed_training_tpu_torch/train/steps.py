"""The train and eval steps: the transformer classifier, the next-token
LM (``--task lm``) and the ResNet image classifier.

Counterparts of the JAX package's ``train/steps.py::make_train_step``
and ``make_eval_step``.  Transformer: in-forward mixup, the training
forward with hash dropout, the mixup criterion, backward, global-norm
clip, the optimizer update and the mixup-weighted accuracy; for the LM,
the training forward with ``mask=None``, the shifted next-token loss
(``lm_shift_metrics``), backward, clip and update.  ResNet: uint8 images
augmented in-step (crop, flip, normalize), mixup by mode
(``resolve_mixup_mode``: static, intra, meta, attn or none), the
training forward (BN running stats updated), the loss, backward, clip
and update, then the mixup-weighted accuracy; the eval step normalizes
and uses the running stats.  Under ``--precision fp16`` (fp32 compute)
the loss is scaled, the grads unscaled and checked, and a step with a
non-finite grad is skipped: parameters, optimizer state and buffers stay
as they were while the step count and the loss scale advance.  Deciding
the skip reads one device bool a step, in fp16 only.  PyTorch runs
eagerly, so there is no compile step; otherwise the step returns its
metrics as device scalars and never waits on the card.

Under ``--quant`` the training forward rolls every amax history once (the
JAX step's mutable ``batch_stats``); the eval step's forward does not.

``--sentinel guard|full`` arms the bad-step guard (JAX ``_sentinel_ok`` /
``_sentinel_metrics``): a step whose loss, global gradient norm or fp16
overflow check is not finite is skipped as the fp16 skip is (the step
count advances, nothing else moves), its metrics are zeroed by a select
and ``bad_steps`` counts it.  At K=1 the skip reads the verdict on the
host, as fp16's does; under a dispatch it is a device select, inside the
captured graph.  ``FDT_FAULT_NAN_AT_STEP=N`` multiplies the loss the
gradients are taken of by NaN where the device step equals N (a
dispatch's step table, or the state's step at K=1).  ``--sentinel
none`` and no fault leave the step as it was.

Under a dispatch the step takes ``scalars`` (the optimizer's per-step
lr or lambda as 0-dim device tensors) and never branches on the device:
the fp16 skip is a select (JAX's ``_tree_where``: parameters, optimizer
state and buffers keep their old values where the grads are not
finite), the loss scale moves in place, and the metrics stay on the
device (``total`` too).

Randomness is explicit.  A ``StepDraws`` holds one u32 seed per dropout
site in the model's call order, the mixup lambda and the permutation,
and for images the crop offsets and flip bits: host values, or under a
K-step dispatch (``train.dispatch``) device tensors read from its [K]
tables by slot (seeds an int64 row, lambda a 0-dim fp32, the rest
integer tensors).  On the card a step uploads the host seeds as one
int64 row, so every kernel reads its seed from the device.
The fused FFN (``--ffn_impl pallas``) takes its two seeds as one (hidden,
connection) pair where the flax FFN takes its hidden and connection
seeds, so the count is the same on both branches.  In a run they come
from generators seeded by (run seed, step) — numpy for lambda and the
permutation, a ``torch.Generator`` for the seeds — so a resumed run
redraws identical values.  They are not the JAX package's
threefry bits; the parity tests hand both packages the same draws, and
every dropout mask is bitwise equal given its seed.

Under a data mesh (``state.placement``, ``parallel.placement``) each
process runs the step on its rows of the global batch, and the step is
the JAX global-batch step: the draws are the global batch's (``b0``, the
rank's first global row, offsets every dropout stream and selects the
rank's mixup partners and crops), the model's collectives (BatchNorm's
global statistics, the amax MAX, the mixup partners) run inside
``DataGroup.active()``, the gradients are reduced to the global mean
(``Placement.reduce_grads``; the LM's loss divides by the global target
count), the update runs on the rank's shard (fsdp / zero1), and the
metrics come back summed over the ranks.  Under tp the data group holds
one rank of each tp group: the model's tp collectives (``TensorGroup``)
make every replicated leaf's gradient the same on each rank of a tp
group, the tp-sharded leaves' gradients stay the rank's, the data
all-reduce runs over the data group alone, and the clip's global norm
sums each sharded leaf's squares over tp and counts each replicated
leaf once (``optim.builder.global_norm``).

Under sequence parallelism (``--mesh sp=S``) every rank of an sp group
holds its data shard's full rows and cuts its positions from them
(``seq_shard``); the model runs those, and the loss is split so that its
sum over the sp group is the JAX step's: the classifier's head runs
replicated on the broadcast CLS row and each rank takes 1/S of its loss;
the LM's rank scores its positions, the target of its last one read
from the full rows, over the count of valid targets summed over dp and
sp.  The gradients are then SUMmed over sp and MEANed over dp
(``Placement.reduce_grads``: one all-reduce over the run, divided by
dp), and the metrics summed over both, the classifier's counted on sp
index 0 only.

Under pipeline parallelism (``--mesh pp=P``, ``state.placement.pipe``)
the Transformer's step runs the tick loop (``pipeline_forward_backward``
over ``parallel.pipeline.run_pipeline``): stage 0 embeds the rank's rows,
each stage runs its chunks on the M microbatches (each at its global
origin ``b0 + m · B_l/M``, its chunk's seeds read from their place in the
call order), the last stage reassembles the rows and runs the head, the
mixup and the loss, and the backward replays the ticks in reverse; the
draws are the data world's (every stage of a data index the same).  The
eval runs the staged forward on the whole local batch, and the last
stage's metrics go to every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.parallel import collectives
from faster_distributed_training_tpu_torch.train import mixup as mx
from faster_distributed_training_tpu_torch.parallel.pipeline import (
    PipelineTickCtx, run_pipeline, virtual_chunks)
from faster_distributed_training_tpu_torch.train.amp import (
    scale_loss, unscale_and_check, update_loss_scale)
from faster_distributed_training_tpu_torch.train.losses import (
    cross_entropy, per_sample_cross_entropy)
from faster_distributed_training_tpu_torch.train.mixup import (
    mixup_criterion, sample_lam)
from faster_distributed_training_tpu_torch.train.state import (
    AppliedCount, TrainState, settle)

Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class StepDraws:
    seeds: Sequence[int]   # one u32 per active dropout site, in call order
    lam: float             # mixup lambda
    perm: np.ndarray       # mixup partner index per row
    crop: Optional[np.ndarray] = None   # images: (n, 2) offsets in [0, 8]
    flip: Optional[np.ndarray] = None   # images: (n,) horizontal flips
    b0: int = 0            # global index of this process's first row
    # the global step as a device int64 (a dispatch's slot of its step
    # table; None: the state's host step), read by the NaN fault
    step: Optional[torch.Tensor] = None
    # FDT_FAULT_NAN_AT_STEP's multiplier of the loss the gradients are
    # taken of (NaN at the armed step, else 1), None when not armed
    poison: Optional[torch.Tensor] = None


def seeds_on(draws: StepDraws, device) -> StepDraws:
    """``draws`` with its host seeds uploaded to a card as one int64 row
    (a pinned, asynchronous copy): each kernel then reads its seed from
    the device.  Unchanged on the CPU or when the seeds are a tensor."""
    if (torch.device(device).type != "cuda" or torch.is_tensor(draws.seeds)
            or not len(draws.seeds)):
        return draws
    row = _pinned(np.asarray(draws.seeds, dtype=np.int64), device)
    return dataclasses.replace(draws, seeds=row)


def resolve_mixup_mode(cfg: TrainConfig) -> str:
    """The image mixup mode: ``--mixup_mode``, else meta under
    ``--meta_learning``, else static when alpha != 0, else none."""
    if cfg.mixup_mode:
        return cfg.mixup_mode
    if cfg.meta_learning:
        return "meta"
    return "static" if cfg.alpha != 0 else "none"


def image_draws(seed: int, step: int, batch_size: int, alpha: float,
                padding: int = 4) -> StepDraws:
    """The draws of image step ``step`` of a run seeded ``seed``."""
    rng = np.random.default_rng((int(seed), int(step)))
    lam = sample_lam(rng, alpha)
    perm = rng.permutation(batch_size)
    crop = rng.integers(0, 2 * padding + 1, size=(batch_size, 2))
    flip = rng.random(batch_size) < 0.5
    return StepDraws(seeds=(), lam=lam, perm=perm, crop=crop, flip=flip)


def _pinned(a, device) -> torch.Tensor:
    """A host array on ``device`` (pinned, an asynchronous copy to a
    card); a tensor already there passes through."""
    if torch.is_tensor(a) and a.device == torch.device(device):
        return a
    t = torch.tensor(np.asarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def mixup_alpha(cfg: TrainConfig) -> float:
    """The model's Beta parameter (the JAX build_model's rule)."""
    return cfg.alpha if cfg.alpha > 0 else 0.99


def step_draws(seed: int, step: int, batch_size: int, n_seeds: int,
               alpha: float) -> StepDraws:
    """The draws of global step ``step`` of a run seeded ``seed``."""
    rng = np.random.default_rng((int(seed), int(step)))
    lam = sample_lam(rng, alpha)
    perm = rng.permutation(batch_size)
    word = np.random.SeedSequence((int(seed), int(step), 1)).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(word >> np.uint64(1)))
    seeds = torch.randint(0, 1 << 32, (n_seeds,), generator=gen,
                          dtype=torch.int64).tolist()
    return StepDraws(seeds=tuple(seeds), lam=lam, perm=perm)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device`` (pinned, asynchronous
    copies to a card).  Token ids and masks stay int32; labels go long."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k == "label":
            t = t.long()
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def seq_shard(batch: Dict[str, torch.Tensor], sp
              ) -> Dict[str, torch.Tensor]:
    """This sp rank's positions of a batch of full rows: the token ids,
    token types and mask cut along the sequence (``[s0, s0 + L/S)``, s0
    the rank's index · L/S); labels and ``valid`` stay.  ``sp`` None:
    the batch itself."""
    if sp is None:
        return batch
    out = dict(batch)
    for k in ("tokens", "token_types", "mask"):
        if k in batch:
            n = sp.part(batch[k].shape[1])
            out[k] = batch[k][:, sp.rank * n:(sp.rank + 1) * n]
    return out


def lm_shift_metrics(logits: torch.Tensor, tokens: torch.Tensor,
                     tok_mask: Optional[torch.Tensor] = None,
                     sample_valid: Optional[torch.Tensor] = None,
                     s0: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shifted next-token objective (the JAX package's
    ``train/steps.py::lm_shift_metrics``): position t of ``logits [B, L,
    V]`` predicts token t+1 of ``tokens [B, L]``.  A target counts when
    its context position and the target itself are real (``tok_mask``),
    crossed with the per-sample ``valid`` of a padded eval batch.  Under
    sp ``logits`` are an sp rank's positions ``[s0, s0 + L_loc)`` of the
    full rows ``tokens`` / ``tok_mask``: the target of its last position
    is the next rank's first token, read from the rows (the last rank's
    last position has none).  Returns fp32 ``(loss_total, correct,
    total)``: the summed per-token cross-entropy, the hits and the count
    of targets."""
    n = min(logits.shape[1], tokens.shape[1] - 1 - int(s0))
    lg = logits[:, :n].float()
    tgt = tokens[:, s0 + 1:s0 + 1 + n].long()
    if tok_mask is not None:
        valid = (tok_mask[:, s0:s0 + n] * tok_mask[:, s0 + 1:s0 + 1 + n]
                 ).float()
    else:
        valid = torch.ones(tgt.shape, dtype=torch.float32, device=lg.device)
    if sample_valid is not None:
        valid = valid * sample_valid.float()[:, None]
    losses = per_sample_cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                      tgt.reshape(-1)).reshape(tgt.shape)
    loss_total = (losses * valid).sum()
    correct = ((lg.argmax(dim=-1) == tgt).float() * valid).sum()
    return loss_total, correct, valid.sum()


def _grads(loss, params: Dict[str, torch.Tensor], loss_scale=None,
           poison=None):
    """Grads by name of ``loss``, scaled by ``loss_scale`` (fp16) and
    multiplied by ``poison`` (the NaN fault, when armed).  The
    backward runs on this thread, not on autograd's worker thread for the
    card: cuDNN caches its autotuned plans per thread, so a ``--remat``
    replay there would pick its own forward algorithms (other bits than
    the forward's), and a rematted and a plain run would not share their
    backward's."""
    scaled = scale_loss(loss, loss_scale, loss_scale is not None)
    if poison is not None:
        scaled = scaled * poison
    with torch.autograd.set_multithreading_enabled(False):
        return dict(zip(params, torch.autograd.grad(scaled,
                                                    list(params.values()))))


def lm_loss_and_grads(model, batch: Dict[str, torch.Tensor],
                      draws: StepDraws, loss_scale=None, group=None):
    """The LM training forward (``mask=None``: packed rows have nothing to
    mask in attention; padded targets leave the loss through
    ``lm_shift_metrics``' token mask), the per-token mean loss and the
    gradients.  Under a data ``group`` the mean is over the global batch's
    targets: this rank's loss is ``world * loss_total / global total``,
    so the mean of the ranks' gradients is the global loss's.  Under sp
    (``group.seq``) the model runs the rank's positions of the full rows
    ``batch``, and the global total sums over sp too (its SUM of the
    ranks' gradients, then the mean over dp, is the global loss's).
    Returns (loss, grads by name, loss_total, correct, total)."""
    sp = None if group is None else group.seq
    part = seq_shard(batch, sp)
    logits = model(part["tokens"], token_types=part.get("token_types"),
                   mask=None, train=True, draws=draws)
    loss_total, correct, total = lm_shift_metrics(
        logits, batch["tokens"], batch.get("mask"),
        s0=0 if sp is None else sp.rank * part["tokens"].shape[1])
    if group is not None and group.live:
        every = group.sum_(total.detach().clone())
        if sp is not None:
            sp.sum_(every)
        loss = loss_total * float(group.world) / torch.clamp(every, min=1.0)
    else:
        loss = loss_total / torch.clamp(total, min=1.0)
    grads = _grads(loss, dict(model.named_parameters()), loss_scale,
                   draws.poison)
    return loss, grads, loss_total, correct, total


def loss_and_grads(model, batch: Dict[str, torch.Tensor], draws: StepDraws,
                   loss_scale=None):
    """The training forward with ``draws``, the mixup criterion and the
    gradients of every parameter (of the scaled loss under fp16).  Under
    sp (the active group's ``seq``) the model runs the rank's positions of
    the full rows ``batch`` and its head runs replicated on every rank of
    the sp group, so each takes 1/S of the loss: the SUM of their
    gradients is the loss's.  Returns (loss, grads by name, logits, y_b,
    lam)."""
    y = batch["label"]
    group = collectives.current()
    sp = None if group is None else group.seq
    part = seq_shard(batch, sp)
    logits, index, lam = model(part["tokens"],
                               token_types=part.get("token_types"),
                               mask=part.get("mask"), train=True,
                               draws=draws)
    lam = lam.to(logits.device)
    y_b = (y if group is None else group.gather(y))[index]
    loss = mixup_criterion(cross_entropy, logits, y, y_b, lam)
    share = loss if sp is None else loss * (1.0 / sp.size)
    grads = _grads(share, dict(model.named_parameters()), loss_scale,
                   draws.poison)
    return loss, grads, logits, y_b, lam


def _stage_pieces(model, spec, batch, train: bool, draws=None,
                  rows: int = 0):
    """(embed, chunk) of a staged forward of ``batch`` (this rank's rows)
    in microbatches of ``rows``: the encoder input, and chunk j's layers
    on microbatch m at its global origin with the chunk's seeds."""
    chunks = virtual_chunks(spec)
    x = batch["tokens"]
    mask = model.attention_mask(None if model.lm else batch.get("mask"), x)
    pos = model.seed_positions()["layers"]

    def embed():
        return model.embed(x, batch.get("token_types"), train,
                           model.seed_stream(draws, x.shape[1])
                           if train else None)

    def chunk(j, h, m):
        layers = chunks[j]
        seeds = (model.seed_stream(draws, x.shape[1], pos[layers[0]],
                                   m * rows) if train else None)
        # a batch-free mask (--lm_causal's [1, 1, L, L]) fits every
        # microbatch as it is
        part = (mask[m * rows:(m + 1) * rows]
                if mask is not None and mask.shape[0] == x.shape[0] else mask)
        return model.run_layers(h, part, train, seeds, layers)

    return embed, chunk


def pipeline_forward_backward(state: TrainState,
                              batch: Dict[str, torch.Tensor],
                              draws: StepDraws, lm: bool, loss_scale=None):
    """The staged training step of this rank's stage (see the module
    docstring).  Returns (loss, grads by name, head outputs): the last
    stage's ``(loss_total, correct, total)`` (LM) or ``(logits, y_b,
    lam)``, None on the other stages; ``grads`` every leaf this rank
    holds (zeros where its stage did not reach it).  The seconds this
    step spent at the stage boundary are left in ``placement.pp_wait``."""
    pl = state.placement
    spec, pipe, group = pl.spec, pl.pipe, pl.group
    model = state.model
    x = batch["tokens"]
    B, L = x.shape[0], x.shape[1]
    M = spec.n_microbatches
    if B % M:
        raise ValueError(f"{B} rows a data rank do not cut into "
                         f"--pp_microbatches {M}")
    rows = B // M
    embed, chunk = _stage_pieces(model, spec, batch, True, draws, rows)

    def head(h):
        seeds = model.seed_stream(draws, L, model.seed_positions()["head"])
        if lm:
            logits = model.head(h, True, draws, seeds)
            loss_total, correct, total = lm_shift_metrics(
                logits, x, batch.get("mask"))
            every = group.sum_(total.detach().clone())
            loss = loss_total * float(group.world) / torch.clamp(every,
                                                                 min=1.0)
            out = (loss, (loss_total, correct, total))
        else:
            logits, index, lam = model.head(h, True, draws, seeds)
            lam = lam.to(logits.device)
            y = batch["label"]
            y_b = group.gather(y)[index]
            loss = mixup_criterion(cross_entropy, logits, y, y_b, lam)
            out = (loss, (logits, y_b, lam))
        scaled = scale_loss(loss, loss_scale, loss_scale is not None)
        if draws.poison is not None:
            scaled = scaled * draws.poison
        return scaled, out

    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    pl.pp_wait = []
    with torch.autograd.set_multithreading_enabled(False):
        res = run_pipeline(
            spec, pipe, M, (rows, L, model.embeddings.d_model), model.dtype,
            x.device, embed if pipe.stage == 0 else None, chunk, head, True,
            PipelineTickCtx(), pl.pp_wait)
    grads = {}
    for k, p in params.items():
        if pl.own(k):
            grads[k] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    if res is None:
        return None, grads, None
    loss, out = res
    return loss, grads, out


def pipeline_logits(state: TrainState, batch: Dict[str, torch.Tensor]):
    """The staged eval forward of this rank's rows (one microbatch): the
    last stage's logits, None on the other stages."""
    pl = state.placement
    model, x = state.model, batch["tokens"]
    embed, chunk = _stage_pieces(model, pl.spec, batch, False,
                                 rows=x.shape[0])
    return run_pipeline(
        pl.spec, pl.pipe, 1, (x.shape[0], x.shape[1],
                              model.embeddings.d_model), model.dtype,
        x.device, embed if pl.pipe.stage == 0 else None, chunk,
        lambda h: (None, model.head(h, False, None, None)), False)


def image_loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                         draws: StepDraws, mode: str, loss_scale=None):
    """The image step's forward: augment (uint8 batches), mixup by
    ``mode``, the training forward (BN running stats updated), the
    criterion and the grads of every trainable leaf, the mixup lambda's
    included.  Returns (loss, grads by name, logits, y_a, y_b, lam)."""
    from faster_distributed_training_tpu_torch.data.augment import (
        augment_batch)

    x, y = batch["image"], batch["label"]
    dev = x.device
    rows = slice(draws.b0, draws.b0 + x.shape[0])
    if x.dtype == torch.uint8:
        x = augment_batch(x, _pinned(draws.crop, dev)[rows],
                          _pinned(draws.flip, dev)[rows], train=True)
    perm = _pinned(draws.perm, dev)
    if mode == "meta":
        x, y_a, y_b, lam = mx.meta_mixup_apply(state.extra["mixup_lambda"],
                                               perm, x, y)
    elif mode == "attn":
        x, y_a, y_b, lam = mx.attn_mixup_apply(state.extra["mixup_lambda"],
                                               perm, x, y)
    elif mode in ("static", "intra"):
        x, y_a, y_b, lam = mx.mixup_data(x, y, draws.lam, perm,
                                         intra_only=mode == "intra")
    elif mode == "none":
        y_a, y_b, lam = y, y, torch.tensor(1.0)
    else:
        raise ValueError(f"unknown mixup mode {mode!r}")
    logits = state.model(x, train=True)
    if mode in ("meta", "attn"):
        loss = mx.mixup_criterion_meta(per_sample_cross_entropy, logits,
                                       y_a, y_b, lam)
    else:
        loss = mixup_criterion(cross_entropy, logits, y_a, y_b, lam)
    grads = _grads(loss, state.params(), loss_scale, draws.poison)
    return loss, grads, logits, y_a, y_b, lam


def _opt_tensors(tree) -> list:
    """Every tensor of an optimizer state tree (host counters skipped)."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _opt_tensors(v)]
    return []


def _select_(finite: torch.Tensor, live, old) -> None:
    """``live`` keeps its values where ``finite``, else takes ``old``'s,
    in place (JAX's ``_tree_where`` on the device)."""
    with torch.no_grad():
        for t, o in zip(live, old):
            t.copy_(torch.where(finite, t, o))


def _update(state: TrainState, grads: Dict[str, torch.Tensor],
            scalars=None) -> None:
    """The optimizer's update of the parameters in place: under a
    placement on this rank's shard of each sharded parameter, then the
    shards made whole again where the placement says."""
    pl = state.placement
    if pl is None:
        state.tx.update(grads, state.opt_state, state.params(), scalars)
        return
    state.tx.update(pl.local(grads), state.opt_state, pl.update_views(state),
                    scalars)
    pl.after_update(state)


def sentinel_ok(loss: Optional[torch.Tensor], grads: Dict[str, torch.Tensor],
                finite: Optional[torch.Tensor]) -> torch.Tensor:
    """The sentinel's bad-step verdict on the device (JAX
    ``train/steps.py::_sentinel_ok``): the loss, the global gradient
    norm and (fp16) the overflow check all finite.  Across processes
    (any mesh) the ranks vote: one bad rank makes every rank skip."""
    import torch.distributed as dist

    norms = torch._foreach_norm(list(grads.values()))
    ok = torch.isfinite(torch.linalg.vector_norm(torch.stack(
        [n.float() for n in norms])))
    if loss is not None:
        ok = ok & torch.isfinite(loss.detach()).reshape(())
    if finite is not None:
        ok = ok & finite
    if dist.is_initialized() and dist.get_world_size() > 1:
        from faster_distributed_training_tpu_torch.parallel.collectives \
            import _comm_device
        bad = (~ok).to(torch.float32).reshape(1).to(_comm_device(None))
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
        ok = bad.to(ok.device)[0] == 0
    return ok


def sentinel_metrics(metrics: Metrics, ok: torch.Tensor) -> Metrics:
    """A guarded step's metrics (JAX ``_sentinel_metrics``): ``loss``,
    ``loss_total``, ``correct`` and ``total`` zeroed by a select (0 *
    NaN is NaN) where the step was bad, so the epoch sums span the steps
    that updated; ``bad_steps`` the verdict counted."""
    out = dict(metrics)
    if "loss_total" not in out:
        out["loss_total"] = out["loss"] * out["total"].to(out["loss"].device)
    for k in ("loss", "loss_total", "correct", "total"):
        v = out[k].to(ok.device)
        out[k] = torch.where(ok, v, torch.zeros_like(v))
    out["bad_steps"] = 1.0 - ok.to(torch.float32)
    return out


# steps between two reads of a guarded K=1 run's applied count
SETTLE_EVERY = 64


def _selects(state: TrainState) -> bool:
    """Whether a guarded K=1 step skips by a device select, as a
    dispatch's step does: on the layouts a dispatch runs (one process,
    or data parallel with every leaf whole and on the card) and without
    NGD, whose factor-refresh gate is a host counter that a skipped step
    must not move.  Elsewhere the verdict is read on the host."""
    pl = state.placement
    if "ngd" in state.opt_state:
        return False
    return pl is None or (pl.tp is None and pl.pipe is None
                          and pl.group.seq is None and not pl.sharding
                          and not pl.offload_params and pl.offload_opt is None)


def apply_update(state: TrainState, grads: Dict[str, torch.Tensor],
                 fp16: bool, buffers=None, scalars=None, loss=None,
                 guard: bool = False) -> torch.Tensor:
    """Clip and update (the optimizer), then advance the step.  Under
    fp16 the grads are unscaled and checked first and the loss scale
    moves; on a non-finite grad the update is skipped and the model's
    buffers go back to ``buffers`` (their values before the forward).
    ``guard`` (``--sentinel guard|full``) generalizes the skip to every
    precision: a step whose ``sentinel_ok`` verdict is false is skipped
    the same way.  With ``scalars`` (a dispatch) the optimizer takes
    them, the skip is a device select and the loss scale moves in place:
    nothing reads the device.  ``grads`` are the reduced (global)
    gradients.  ``guard`` without ``scalars`` (K=1) takes the same device
    select where ``_selects``, its scalars from ``state.applied`` (the
    optimizer steps applied, counted on the device and read every
    ``SETTLE_EVERY`` steps).  Returns the device bool of an applied update
    (fp16's ``finite``, or the guard's verdict).  Under pp every stage takes one
    decision: each checked only the leaves it holds, so a non-finite grad
    on any stage skips the step and backs the scale off on all of
    them."""
    grads, finite = unscale_and_check(grads, state.loss_scale, fp16)
    pipe = state.placement.pipe if state.placement is not None else None
    if fp16 and pipe is not None and pipe.live:
        finite = pipe.sum_((~finite).float()) == 0
    new_scale = update_loss_scale(state.loss_scale, finite, fp16)
    ok = (sentinel_ok(loss, grads, finite if fp16 else None) if guard
          else finite)
    skips = fp16 or guard
    count = None
    if scalars is None and guard and _selects(state):
        count = state.applied
        if count is None or not count.skips:
            # (a dispatch's count without skips counts every step)
            settle(state)
            count = state.applied = AppliedCount(
                SETTLE_EVERY, ok.device, skips=True)
        count.reserve(state, 1)
        scalars = count.scalars()
    if scalars is not None:
        live = old = ()
        if skips:
            live = (list(state.params().values())
                    + _opt_tensors(state.opt_state))
            old = [t.detach().clone() for t in live]
        _update(state, grads, scalars)
        if skips:
            _select_(ok, live + list(state.model.buffers()),
                     old + list(buffers))
        if fp16:
            state.loss_scale.scale.copy_(new_scale.scale)
            state.loss_scale.growth_count.copy_(new_scale.growth_count)
        if count is not None:
            count.applied.add_(ok.to(torch.int64))
            count.advance(state, 1)
        state.step += 1
        return ok
    if skips and not bool(ok):
        with torch.no_grad():
            for b, old in zip(state.model.buffers(), buffers):
                b.copy_(old)
    else:
        _update(state, grads)
    state.loss_scale = new_scale
    state.step += 1
    return ok


def _snapshot(state: TrainState, skips: bool):
    """The buffers' values before the forward, for a skipped step (fp16
    or the sentinel's guard)."""
    if not skips:
        return None
    return [b.detach().clone() for b in state.model.buffers()]


def _data_group(state: TrainState):
    """The step's live DataGroup, or None (one process)."""
    pl = state.placement
    return pl.group if pl is not None and pl.group.live else None


def _head_once(state: TrainState, metrics: Metrics) -> Metrics:
    """The classifier's metrics as sp index 0 counts them (zeros on the
    other ranks of its sp group, whose replicated head computed the
    same), so their sum over the run counts each row once."""
    group = _data_group(state)
    if group is None or group.seq is None or group.seq.rank == 0:
        return metrics
    return {k: torch.zeros_like(torch.as_tensor(v))
            for k, v in metrics.items()}


def make_train_step(cfg: TrainConfig) -> Callable[..., Tuple[TrainState,
                                                             Metrics]]:
    """``step(state, batch, draws=None, scalars=None) -> (state,
    metrics)``; ``batch`` holds device tensors (``to_device``): this
    process's rows of the global batch.  Without ``draws`` the step
    derives the global batch's from (state.seed, state.step).
    ``scalars``: a dispatch's device scalars for the optimizer (see the
    module docstring); its metrics then also hold ``finite`` (fp16).
    Updates the state in place and advances its step."""
    from faster_distributed_training_tpu_torch.resilience.faults import (
        graph_nan_at)

    alpha = mixup_alpha(cfg)
    lm = cfg.task == "lm"
    image = cfg.model != "transformer"
    mode = resolve_mixup_mode(cfg)
    fp16 = cfg.precision == "fp16"
    # --sentinel guard|full: the in-graph bad-step guard; none leaves the
    # step as it was
    guard = (cfg.sentinel or "none") != "none"
    nan_at = graph_nan_at()

    def forward_backward(state, batch, draws, group):
        """(draws, loss, grads, metric inputs) of this rank's rows."""
        ls = state.loss_scale if fp16 else None
        world = 1 if group is None else group.world
        B = batch["image" if image else "tokens"].shape[0]
        if image:
            draws = draws or image_draws(state.seed, state.step, B * world,
                                         cfg.alpha)
        else:
            # the LM draws lambda and the permutation too and never uses
            # them, as the JAX step threads its mixup key
            draws = seeds_on(draws or step_draws(
                state.seed, state.step, B * world,
                state.model.n_dropout_sites(), alpha),
                batch["tokens"].device)
        if group is not None:
            draws = dataclasses.replace(draws, b0=group.origin(B))
        if nan_at is not None:
            dev = next(iter(batch.values())).device
            at = (draws.step if draws.step is not None else torch.full(
                (), int(state.step), dtype=torch.int64, device=dev))
            draws = dataclasses.replace(draws, poison=torch.where(
                at == nan_at, float("nan"), 1.0))
        if state.placement is not None and state.placement.pipe is not None:
            loss, grads, out = pipeline_forward_backward(state, batch, draws,
                                                         lm, ls)
            if out is not None and not lm:
                out = (out[0], batch["label"], out[1], out[2])
            return B, loss, grads, out
        if image:
            loss, grads, logits, y_a, y_b, lam = image_loss_and_grads(
                state, batch, draws, mode, ls)
            return B, loss, grads, (logits, y_a, y_b, lam)
        if lm:
            loss, grads, loss_total, correct, total = lm_loss_and_grads(
                state.model, batch, draws, ls, group)
            return B, loss, grads, (loss_total, correct, total)
        loss, grads, logits, y_b, lam = loss_and_grads(state.model, batch,
                                                       draws, ls)
        return B, loss, grads, (logits, batch["label"], y_b, lam)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws = None, scalars=None
             ) -> Tuple[TrainState, Metrics]:
        pl = state.placement
        if pl is not None:
            pl.unpark(state)
        group = _data_group(state)
        buffers = _snapshot(state, fp16 or guard)
        with (group.active() if group is not None
              else contextlib.nullcontext()):
            B, loss, grads, out = forward_backward(state, batch, draws,
                                                   group)
        if pl is not None:
            grads = pl.reduce_grads(grads)
        finite = apply_update(state, grads, fp16, buffers, scalars,
                              loss=loss, guard=guard)
        if out is None:
            # a pipeline stage before the last: the last stage's metrics
            # come to it in reduce_metrics
            dev = next(iter(grads.values())).device
            metrics = {k: torch.zeros((), device=dev) for k in (
                ("loss", "loss_total", "correct", "total") if lm
                else ("loss", "correct", "total"))}
        elif lm:
            loss_total, correct, total = out
            # loss is the per-token mean; loss_total / total the exact
            # token-weighted epoch loss; accuracy is next-token accuracy
            metrics = {"loss": loss.detach(),
                       "loss_total": loss_total.detach(),
                       "correct": correct, "total": total}
        else:
            logits, y_a, y_b, lam = out
            # the mixup-weighted accuracy: lam a scalar or one a sample
            with torch.no_grad():
                pred = logits.argmax(dim=-1)
                correct = (lam * (pred == y_a) + (1.0 - lam)
                           * (pred == y_b)).sum() if lam.dim() else (
                    lam * (pred == y_a).sum()
                    + (1.0 - lam) * (pred == y_b).sum())
            total = (torch.tensor(float(B)) if scalars is None else
                     torch.full((), float(B), device=logits.device))
            metrics = _head_once(state, {"loss": loss.detach().float(),
                                         "correct": correct.float(),
                                         "total": total})
        if pl is not None:
            metrics = pl.reduce_metrics(metrics)
            pl.park(state)
        if guard:
            metrics = sentinel_metrics(metrics, finite)
        if fp16:
            metrics["loss_scale"] = state.loss_scale.scale
        if (fp16 or guard) and scalars is not None:
            metrics["finite"] = finite
        return state, metrics

    return step


def make_eval_step(cfg: TrainConfig) -> Callable[[TrainState, Dict],
                                                 Metrics]:
    """Eval: deterministic forward (no dropout, no mixup); a padded final
    batch's ``valid`` mask keeps its pad rows out of every sum.  The LM
    evaluates the shifted next-token objective.  Under a data mesh the
    sums are over every rank's rows."""
    lm = cfg.task == "lm"
    image = cfg.model != "transformer"

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Metrics:
        m = local_step(state, batch)
        if state.placement is None or not state.placement.group.live:
            return m
        m = state.placement.reduce_metrics(m)
        m["loss"] = m["loss_total"] / torch.clamp(m["total"], min=1.0)
        return m

    @torch.no_grad()
    def local_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Metrics:
        group = _data_group(state)
        sp = None if group is None else group.seq
        full, batch = batch, seq_shard(batch, sp)
        pl = state.placement
        if pl is not None and pl.pipe is not None:
            logits = pipeline_logits(state, batch)
            if logits is None:
                # the last stage's metrics come in reduce_metrics
                dev = batch["tokens"].device
                return {k: torch.zeros((), device=dev) for k in (
                    "loss", "loss_total", "correct", "total")}
            if lm:
                loss_total, correct, total = lm_shift_metrics(
                    logits, full["tokens"], full.get("mask"),
                    full.get("valid"))
                return {"loss": loss_total / torch.clamp(total, min=1.0),
                        "loss_total": loss_total, "correct": correct,
                        "total": total}
        elif image:
            from faster_distributed_training_tpu_torch.data.augment import (
                normalize)
            x = batch["image"]
            if x.dtype == torch.uint8:
                x = normalize(x)
            logits = state.model(x, train=False)
        elif lm:
            logits = state.model(batch["tokens"],
                                 token_types=batch.get("token_types"),
                                 mask=None, train=False)
            loss_total, correct, total = lm_shift_metrics(
                logits, full["tokens"], full.get("mask"), full.get("valid"),
                s0=0 if sp is None else sp.rank * batch["tokens"].shape[1])
            return {"loss": loss_total / torch.clamp(total, min=1.0),
                    "loss_total": loss_total, "correct": correct,
                    "total": total}
        else:
            logits = state.model(batch["tokens"],
                                 token_types=batch.get("token_types"),
                                 mask=batch.get("mask"), train=False)
        y = batch["label"]
        hit = (logits.argmax(dim=-1) == y).float()
        losses = per_sample_cross_entropy(logits, y)
        valid = batch.get("valid")
        if valid is None:
            loss_total, correct = losses.sum(), hit.sum()
            total = torch.tensor(float(y.shape[0]))
        else:
            valid = valid.float()
            loss_total = (losses * valid).sum()
            correct = (hit * valid).sum()
            total = valid.sum()
        return _head_once(state, {
            "loss": loss_total / torch.clamp(total.to(loss_total.device),
                                             min=1.0),
            "loss_total": loss_total, "correct": correct, "total": total})

    return step
