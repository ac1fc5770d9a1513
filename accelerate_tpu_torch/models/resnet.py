"""ResNet image classifier, the model of ``cv_example`` (mirrors
``accelerate_tpu/models/resnet.py``).

Inputs are NHWC, as in JAX; the forward views them as NCHW in the
channels-last memory format, which is the layout cuDNN's convolutions
take on the card.  Convolutions pad as flax's ``"SAME"`` (the low side
gets the smaller half, so a stride-2 layer pads ``(2, 3)`` where a
symmetric pad would shift the grid), with f32 parameters cast to the
compute dtype; max pooling pads with -inf.

Batch norm is flax's: statistics of the batch in f32, the biased
variance (``E[x^2] - E[x]^2``, floored at 0), eps 1e-5, and the running
averages ``0.9 * old + 0.1 * batch`` (flax's ``momentum=0.9``, torch's
0.1).  The running averages are the module's buffers ``mean`` / ``var``
and are not updated in place: ``forward(x, train=True)`` returns
``(logits, batch_stats)``, the new averages by module name, which a train
step carries out as its ``aux`` and :meth:`ResNet.load_batch_stats` folds
back, as ``cv_example.py`` folds flax's ``batch_stats``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .bert import _Dense
from .llama import _apply

BN_MOMENTUM = 0.9      # flax's: the old average's weight
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)  # resnet18
    num_filters: int = 64
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def resnet18(cls, **kw):
        return cls(stage_sizes=(2, 2, 2, 2), **kw)

    @classmethod
    def resnet50(cls, **kw):
        """The JAX package's resnet50 stages (3, 4, 6, 3) of its two-conv
        blocks."""
        return cls(stage_sizes=(3, 4, 6, 3), **kw)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
        defaults.update(kw)
        return cls(**defaults)


def _same_pad(x, kernel: int, stride: int, value: float = 0.0):
    """Pad NCHW ``x`` as XLA's ``SAME``: out = ceil(in / stride), the total
    pad split with the smaller half first."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad's order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class Conv(nn.Module):
    """Bias-free convolution, f32 weight ``[out, in, k, k]`` run in
    ``dtype``, flax ``SAME`` padding."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))

    def forward(self, x):
        x = _same_pad(x.to(self.dtype), self.kernel, self.stride)
        x = x.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over NCHW channels (module docstring)."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, stats: dict | None = None, name: str = ""):
        x32 = x.float()
        if stats is not None:          # training: the batch's statistics
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                stats[name] = {
                    "mean": BN_MOMENTUM * self.mean + (1.0 - BN_MOMENTUM) * mean.detach(),
                    "var": BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var.detach()}
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.weight.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(self.dtype)


class ResNetBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(c_in, filters, 3, stride, dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters, 3, 1, dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.downsample = self.bn_down = None
        if stride != 1 or c_in != filters:
            self.downsample = Conv(c_in, filters, 1, stride, dtype)
            self.bn_down = BatchNorm(filters, dtype)

    def forward(self, x, stats=None, prefix: str = ""):
        y = F.relu(self.bn1(self.conv1(x), stats, prefix + "bn1"))
        y = self.bn2(self.conv2(y), stats, prefix + "bn2")
        residual = x
        if self.downsample is not None:
            residual = self.bn_down(self.downsample(x), stats, prefix + "bn_down")
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward(images [B, H, W, C], train=True)``: ``(logits,
    batch_stats)`` when training, the logits (f32) otherwise.  Built on
    ``device`` (``"cuda"`` unless the caller asks for the CPU) with random
    weights from ``seed``."""

    def __init__(self, config: ResNetConfig, *, in_channels: int = 3, device=None,
                 seed: int = 0):
        super().__init__()
        self.config = cfg = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.stem_conv = Conv(in_channels, cfg.num_filters, 7, 2, cfg.dtype)
            self.stem_bn = BatchNorm(cfg.num_filters, cfg.dtype)
            blocks, c_in = {}, cfg.num_filters
            for stage, n in enumerate(cfg.stage_sizes):
                filters = cfg.num_filters * 2 ** stage
                for block in range(n):
                    stride = 2 if stage > 0 and block == 0 else 1
                    blocks[f"stage{stage}_block{block}"] = ResNetBlock(c_in, filters, stride,
                                                                       cfg.dtype)
                    c_in = filters
            self.blocks = nn.ModuleDict(blocks)
            self.classifier = _Dense(c_in, cfg.num_classes, torch.float32)
        if self.device.type != "meta":       # big_modeling.init_empty_weights: no init
            self._init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Convolutions ~ N(0, 2 / fan_in) (He), the classifier ~ N(0, 1 /
        fan_in), biases zeros, batch-norm scales ones."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen, device=self.device)
                        * (2.0 / fan_in) ** 0.5)
            elif name == "classifier.weight":
                p.copy_(torch.randn(p.shape, generator=gen, device=self.device)
                        / p.shape[1] ** 0.5)
            elif name == "classifier.bias":
                p.zero_()

    def forward(self, images, train: bool = True):
        stats = {} if train else None
        x = images.permute(0, 3, 1, 2)               # NHWC -> NCHW, channels-last memory
        x = F.relu(self.stem_bn(self.stem_conv(x), stats, "stem_bn"))
        x = F.max_pool2d(_same_pad(x, 3, 2, value=float("-inf")), 3, stride=2)
        for name, block in self.blocks.items():
            x = block(x, stats, f"blocks.{name}.")
        # the mean in the compute dtype, then f32 (flax's jnp.mean, astype)
        logits = self.classifier(x.mean(dim=(2, 3)).float())
        return (logits, stats) if train else logits

    @torch.no_grad()
    def load_batch_stats(self, batch_stats: dict) -> None:
        """Fold a train step's ``batch_stats`` (``{module name: {"mean",
        "var"}}``) into the running averages."""
        for name, s in batch_stats.items():
            bn = self.get_submodule(name)
            bn.mean.copy_(s["mean"])
            bn.var.copy_(s["var"])


def make_resnet_loss_fn(model: ResNet):
    """``loss_fn(params, batch) -> (loss, batch_stats)`` for
    ``Accelerator.prepare_train_step(..., has_aux=True)``: the mean
    cross-entropy of ``batch["label"]`` on ``batch["image"]`` (NHWC) in
    training mode, and the new running averages."""

    def loss_fn(params, batch):
        logits, stats = _apply(model, params, batch["image"], train=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, batch["label"].long()[:, None]).mean(), stats

    return loss_fn
