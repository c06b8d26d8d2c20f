"""ResNet image encoder (the port of ``btia_tpu/models/resnet.py``).

NHWC in, tokens out: (B, H/32 * W/32, C) in row-major grid order (fewer
stages, a finer grid). torchvision v1.5 bottlenecks: conv1 (1x1) -> BN ->
ReLU -> conv2 (3x3, the stride) -> BN -> ReLU -> conv3 (1x1) -> BN, the
residual through a strided 1x1 conv + BN where the shape changes; stem 7x7/2
conv + BN + ReLU + 3x3/2 max-pool (padding 1). Every convolution pads k // 2
on each side and has no bias.

Dtypes as the reference's: convolutions in the compute dtype, BatchNorm in
the accum dtype (f32), ``(y + residual)`` cast to the compute dtype before
the ReLU (``resnet.py:68-77``). The convolutions are cuDNN's on the card
(``F.conv2d`` on channels-last views), as the reference leaves them to
XLA; under the fp32 policy they run with TF32 off, forward and backward,
in a local ``torch.backends.cudnn.flags`` context, so that f32 stays f32
whatever the caller's global setting.

Conv kernels are stored (out, in, kh, kw), PyTorch's layout; the weight
bridge transposes flax's HWIO kernels (``convert/from_jax.py``). BatchNorm
is flax's: batch statistics in train mode with the fast variance
max(0, E[x^2] - E[x]^2), running averages with momentum 0.9 of the *biased*
variance (written here, not ``F.batch_norm``'s unbiased update), eps 1e-5;
the running statistics are buffers ``mean`` and ``var``, so state dicts and
checkpoints carry them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import _param
from btia_tpu_torch.parallel.collectives import all_reduce_sum
from btia_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

STAGE_SIZES = {  # torchvision layer multiplicities
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet_tiny": (1, 1, 1, 1),  # tests / CI only
    "resnet_small": (1, 1, 1),  # 3 stages: 16x downsample, 1024-d
    "resnet_xsmall": (1, 1),  # 2 stages: 8x downsample, 512-d
}

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _no_tf32():
    """cuDNN with TF32 off, its other settings as they are."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic, allow_tf32=False)


class _F32Conv(torch.autograd.Function):
    """An f32 convolution whose forward and backward both run with TF32 off:
    the backward runs inside ``loss.backward()``, outside any context the
    forward set, and would read cuDNN's global ``allow_tf32`` there."""

    @staticmethod
    def forward(ctx, x, w, stride, pad):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pad = stride, pad
        with _no_tf32():
            return F.conv2d(x, w, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [ctx.stride] * 2, [ctx.pad] * 2, [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias, padding k // 2 on each side, on NHWC
    tensors in the compute dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, policy: DTypePolicy, device=None):
        super().__init__()
        self.stride, self.pad = stride, k // 2
        self.policy = policy
        self.kernel = _param(cout, cin, k, k, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        # NHWC permuted to an NCHW view: channels-last to cuDNN, no copy.
        x, w = x.to(cd).permute(0, 3, 1, 2), self.kernel.to(cd)
        if cd == torch.float32:
            y = _F32Conv.apply(x, w, self.stride, self.pad)
        else:
            y = F.conv2d(x, w, stride=self.stride, padding=self.pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NHWC tensor, in f32.

    Under a data axis (``ops.fused_mesh``) the batch statistics are the
    global batch's, as the reference's are under pjit: the per-channel sums
    and sums of squares are summed over the data group (forward and
    backward) before the variance, and the running averages move by the
    global statistics, the same on every rank."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.scale = _param(channels, device=device)
        self.bias = _param(channels, device=device)
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            dp = axis_size(DATA_AXIS)
            if dp > 1:
                n = dp * x[..., 0].numel()
                sums = all_reduce_sum(torch.stack([x.sum(dims), (x * x).sum(dims)]), DATA_AXIS)
                mean, sq = sums[0] / n, sums[1] / n
            else:
                mean, sq = x.mean(dims), (x * x).mean(dims)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():  # flax's running update, the biased variance
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, policy: DTypePolicy, device=None):
        super().__init__()
        self.policy = policy
        out = 4 * features
        self.conv1 = Conv(cin, features, 1, 1, policy, device)
        self.bn1 = BatchNorm(features, device)
        self.conv2 = Conv(features, features, 3, stride, policy, device)
        self.bn2 = BatchNorm(features, device)
        self.conv3 = Conv(features, out, 1, 1, policy, device)
        self.bn3 = BatchNorm(out, device)
        self.project = cin != out or stride != 1
        if self.project:
            self.downsample_conv = Conv(cin, out, 1, stride, policy, device)
            self.downsample_bn = BatchNorm(out, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = self.downsample_bn(self.downsample_conv(x), train) if self.project else x
        return F.relu((y + residual).to(self.policy.compute_dtype))


class ResNet(nn.Module):
    """Feature-grid ResNet. Output: (B, H/2^(s+1) * W/2^(s+1), 256 * 2^(s-1))
    tokens for s stages: (B, 49, 2048) for ResNet-50 at 224."""

    def __init__(self, stage_sizes, policy: DTypePolicy, device=None):
        super().__init__()
        self.policy = policy
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = Conv(3, 64, 7, 2, policy, device)
        self.stem_bn = BatchNorm(64, device)
        cin = 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                features = 64 * 2**stage
                stride = 2 if (block == 0 and stage > 0) else 1
                self.add_module(f"stage{stage + 1}_block{block}",
                                Bottleneck(cin, features, stride, policy, device))
                cin = 4 * features

    def forward(self, x: torch.Tensor, drop=None, train: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC. ``drop`` is unused (the encoder has no
        dropout); it keeps the ViT's call signature."""
        cd = self.policy.compute_dtype
        x = F.relu(self.stem_bn(self.stem_conv(x.to(cd)), train).to(cd))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                x = getattr(self, f"stage{stage + 1}_block{block}")(x, train)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)


def build_resnet(name: str, policy: DTypePolicy = DTypePolicy(), device=None) -> ResNet:
    return ResNet(STAGE_SIZES[name], policy, device)


def resnet50(policy: DTypePolicy = DTypePolicy(), device=None) -> ResNet:
    return build_resnet("resnet50", policy, device)
