"""The ResNet family for 32x32 inputs (the JAX package's
``models/resnet.py``), same architecture and numerics:

  * CIFAR stem: 3x3 conv, stride 1; stage 1 stride 1;
  * CELU(alpha=0.075) in the stem and ``BasicBlock``, ReLU in
    ``BottleNeck``;
  * ``FusedConvBNLayer`` (no affine, eps 1e-3 added to the std, the
    backward recomputes the conv output) for every stride-1 conv, and
    ``ConvBN`` (conv + an affine BatchNorm with running stats) for
    strided convs and shortcuts;
  * torch-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init;
  * fp32 logits.

Submodules and leaves carry the flax names (``FusedConvBNLayer_0``,
``BottleNeck_3/ConvBN_1/BatchNorm_0/scale``, ``fc_kernel``), so
``interop`` maps a flax tree onto the ``state_dict`` by its path.  Conv
kernels are OIHW and ``fc_kernel`` is (out, in).  ``forward`` takes NHWC
images, as the JAX model does, and runs NCHW inside (a ``permute`` view,
which is ``torch.channels_last`` in memory: cuDNN's fast layout for bf16).
Parameters stay fp32; each conv casts its kernel to the compute dtype.
The running statistics are buffers (``mean``, ``var``) updated in place
by a training forward.  ``remat=True`` (``--remat``, JAX's ``nn.remat`` of
every residual block) checkpoints each block; the replay in the backward
leaves the running statistics alone (``models.remat.replaying``), so they
update once a step, as without remat.  Under a data mesh every
BatchNorm's statistics are the global batch's (``ops.conv_bn``; the
affine ``BatchNorm`` averages its per-channel means over the ranks with a
gradient, ``DataGroup.mean``), so the running statistics are the same on
every rank.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from faster_distributed_training_tpu_torch.models.remat import (
    remat as checkpointed, replaying)
from faster_distributed_training_tpu_torch.ops.conv_bn import (
    conv2d, conv_bn_train, stats_dtype)
from faster_distributed_training_tpu_torch.parallel import collectives

CELU_ALPHA = 0.075


def celu(x: torch.Tensor) -> torch.Tensor:
    return F.celu(x, alpha=CELU_ALPHA)


class FusedConvBNLayer(nn.Module):
    """Conv + BN through ``ops.conv_bn``; running stats with torch's
    momentum 0.1 over the unbiased batch variance."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0, eps: float = 1e-3, momentum: float = 0.1,
                 dtype: torch.dtype = torch.float32, conv_remat: bool = True):
        super().__init__()
        self.stride, self.padding, self.eps = stride, padding, eps
        self.momentum, self.dtype, self.conv_remat = momentum, dtype, conv_remat
        self.kernel = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xc, wc = x.to(self.dtype), self.kernel.to(self.dtype)
        if train:
            out, mean, var = conv_bn_train(xc, wc, self.stride, self.padding,
                                           self.eps, remat=self.conv_remat)
            m = self.momentum
            if not replaying():
                with torch.no_grad():
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * var)
            return out
        y = conv2d(xc, wc, self.stride, self.padding)
        out = ((y.to(stats_dtype(y.dtype)) - self.mean[None, :, None, None])
               / (torch.sqrt(self.var) + self.eps)[None, :, None, None])
        return out.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5), not torch's: fp32
    single-pass statistics ``E[x²] − E[x]²`` clipped at 0, the biased
    variance both for normalizing and for the running var, and
    ``(x − mean) · (scale · rsqrt(var + eps)) + bias``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.to(stats_dtype(x.dtype))
        if train:
            mean = x32.mean(dim=(0, 2, 3))
            mean_sq = torch.square(x32).mean(dim=(0, 2, 3))
            group = collectives.current()
            if group is not None:
                mean, mean_sq = group.mean(torch.stack([mean, mean_sq])
                                           ).unbind(0)
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            m = self.momentum
            if not replaying():
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(self.dtype)


class ConvBN(nn.Module):
    """Plain conv (no bias) + the affine BatchNorm: the reference's
    ``nn.Conv2d`` + ``nn.BatchNorm2d`` pair for strided convs and
    shortcuts."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.kernel = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = conv2d(x.to(self.dtype), self.kernel.to(self.dtype), self.stride,
                   self.padding)
        return self.BatchNorm_0(y, train)


class BasicBlock(nn.Module):
    """Expansion 1, CELU activations."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, conv_remat: bool = True):
        super().__init__()
        kw = dict(dtype=dtype)
        fkw = dict(kw, conv_remat=conv_remat)
        f, out = features, features * self.expansion
        self.stride = stride
        if stride != 1:
            self.ConvBN_0 = ConvBN(cin, f, 3, stride, 1, **kw)
            self.FusedConvBNLayer_0 = FusedConvBNLayer(f, out, 3, 1, 1, **fkw)
        else:
            self.FusedConvBNLayer_0 = FusedConvBNLayer(cin, f, 3, 1, 1, **fkw)
            self.FusedConvBNLayer_1 = FusedConvBNLayer(f, out, 3, 1, 1, **fkw)
        # the shortcut takes flax's next ConvBN name
        self.shortcut = None
        if stride != 1 or cin != out:
            self.shortcut = "ConvBN_1" if stride != 1 else "ConvBN_0"
            self.add_module(self.shortcut, ConvBN(cin, out, 1, stride, 0,
                                                  **kw))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.stride != 1:
            h = celu(self.ConvBN_0(x, train))
            h = self.FusedConvBNLayer_0(h, train)
        else:
            h = celu(self.FusedConvBNLayer_0(x, train))
            h = self.FusedConvBNLayer_1(h, train)
        if self.shortcut is not None:
            x = getattr(self, self.shortcut)(x, train)
        return celu(h + x)


class BottleNeck(nn.Module):
    """Expansion 4, ReLU activations."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, conv_remat: bool = True):
        super().__init__()
        kw = dict(dtype=dtype)
        fkw = dict(kw, conv_remat=conv_remat)
        f, out = features, features * self.expansion
        self.stride = stride
        self.FusedConvBNLayer_0 = FusedConvBNLayer(cin, f, 1, 1, 0, **fkw)
        if stride != 1:
            self.ConvBN_0 = ConvBN(f, f, 3, stride, 1, **kw)
            self.FusedConvBNLayer_1 = FusedConvBNLayer(f, out, 1, 1, 0, **fkw)
        else:
            self.FusedConvBNLayer_1 = FusedConvBNLayer(f, f, 3, 1, 1, **fkw)
            self.FusedConvBNLayer_2 = FusedConvBNLayer(f, out, 1, 1, 0, **fkw)
        # the shortcut takes flax's next ConvBN name
        self.shortcut = None
        if stride != 1 or cin != out:
            self.shortcut = "ConvBN_1" if stride != 1 else "ConvBN_0"
            self.add_module(self.shortcut, ConvBN(cin, out, 1, stride, 0,
                                                  **kw))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = torch.relu(self.FusedConvBNLayer_0(x, train))
        if self.stride != 1:
            h = torch.relu(self.ConvBN_0(h, train))
            h = self.FusedConvBNLayer_1(h, train)
        else:
            h = torch.relu(self.FusedConvBNLayer_1(h, train))
            h = self.FusedConvBNLayer_2(h, train)
        if self.shortcut is not None:
            x = getattr(self, self.shortcut)(x, train)
        return torch.relu(h + x)


class ResNet(nn.Module):
    """Stem + 4 stages + global average pool + fc."""

    def __init__(self, block, stage_sizes: Sequence[int],
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 conv_remat: bool = True, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.FusedConvBNLayer_0 = FusedConvBNLayer(3, 64, 3, 1, 1, dtype=dtype,
                                                   conv_remat=conv_remat)
        self.blocks = []
        cin, i = 64, 0
        for n_blocks, features, stride in zip(stage_sizes, (64, 128, 256, 512),
                                              (1, 2, 2, 2)):
            for b in range(n_blocks):
                blk = block(cin, features, stride if b == 0 else 1,
                            dtype=dtype, conv_remat=conv_remat)
                self.add_module(f"{block.__name__}_{i}", blk)
                self.blocks.append(blk)
                cin, i = features * block.expansion, i + 1
        self.fc_kernel = nn.Parameter(torch.empty(num_classes, cin))
        self.fc_bias = nn.Parameter(torch.empty(num_classes))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """torch-style uniform init from ``generator``: every conv kernel
        and the fc kernel and bias at 1/sqrt(fan_in); BN scales 1, biases
        0; running means 0 and variances 1."""
        for name, p in self.named_parameters():
            if name.endswith("BatchNorm_0.scale"):
                p.fill_(1.0)
            elif name.endswith("BatchNorm_0.bias"):
                p.zero_()
            else:
                fan_in = (self.fc_kernel.shape[1] if name.startswith("fc_")
                          else p[0].numel())
                bound = 1.0 / math.sqrt(fan_in)
                p.uniform_(-bound, bound, generator=generator)
        for name, b in self.named_buffers():
            b.fill_(0.0 if name.endswith("mean") else 1.0)
        return self

    def jax_layouts(self) -> dict:
        """Each parameter's permutation into the flax layout, where it
        differs: conv kernels OIHW -> HWIO, ``fc_kernel`` (out, in) ->
        (in, out).  NGD preconditions the axes in the flax order."""
        return {n: (2, 3, 1, 0) if p.dim() == 4 else (1, 0)
                for n, p in self.named_parameters() if p.dim() in (2, 4)}

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """NHWC images -> fp32 logits."""
        x = x.permute(0, 3, 1, 2)
        x = celu(self.FusedConvBNLayer_0(x, train))
        for blk in self.blocks:
            if self.remat and train and torch.is_grad_enabled():
                x = checkpointed(lambda t, b=blk: b(t, True), blk, x)
            else:
                x = blk(x, train)
        # the global average pool: an fp32 mean, cast back (jnp.mean)
        x = x.to(stats_dtype(x.dtype)).mean(dim=(2, 3)).to(self.dtype)
        out = F.linear(x, self.fc_kernel.to(self.dtype),
                       self.fc_bias.to(self.dtype))
        return out.float()


def _factory(block, sizes):
    def make(num_classes: int = 10, **kw) -> ResNet:
        return ResNet(block, sizes, num_classes=num_classes, **kw)
    return make


resnet18 = _factory(BasicBlock, (2, 2, 2, 2))
resnet34 = _factory(BasicBlock, (3, 4, 6, 3))
resnet50 = _factory(BottleNeck, (3, 4, 6, 3))
resnet101 = _factory(BottleNeck, (3, 4, 23, 3))
resnet152 = _factory(BottleNeck, (3, 8, 36, 3))
RESNETS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
           "resnet101": resnet101, "resnet152": resnet152}
