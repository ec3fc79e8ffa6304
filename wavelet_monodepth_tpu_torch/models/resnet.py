"""ResNet encoders (18/34/50/101/152) emitting the 5-level feature pyramid
the decoders use.

Counterpart of `wavelet_monodepth_tpu/models/resnet.py`. torchvision's
topology and names under the reference's `encoder.` scope, so a
reference `encoder.pth` (or the pose net's `pose_encoder.pth`) loads
into it:
conv7x7/2 -> [relu feat0] -> maxpool3/2 -> layer1..4 at strides 4..32,
BN eps 1e-5, input normalised as (x - 0.45) / 0.225 (unless
`normalize_input=False`, the NYU default). ResNet18/34 stack
BasicBlocks, 50/101/152 Bottlenecks (1x1, 3x3 carrying the stride as in
torchvision v1.5, 1x1 at 4x width), so `num_ch_enc` is
(64, 64, 128, 256, 512) or (64, 256, 512, 1024, 2048). Takes NHWC images
and returns NHWC features; inside, convs run on channels_last NCHW views.
`num_input_images=n` is the pose encoder (`resnet_encoder.py:17-59`):
the stem takes n frames stacked on the channel axis, 3n channels.

The JAX encoder folds the input normalisation into the stem's BN at
inference (`resnet.py:107-140`), a TPU micro-optimisation equal to the
plain form up to reassociation; the port keeps the plain form, so
features agree with JAX to float32 rounding, not bit for bit.

BatchNorm is `BatchNorm2d` below: torch's in eval mode; in train mode it
normalises with the batch statistics as torch does but updates the
running variance with the *biased* batch variance, as flax does (torch
uses the unbiased one). The port is held to the JAX package. In
bfloat16, eval mode runs in the module's dtype (after a full cast the
running statistics are bfloat16, as JAX casts its batch_stats), and
train mode computes the batch statistics in float32, as flax does, and
keeps float32 running statistics exact. Under data parallelism (more
than one rank, `parallel/mesh.py`) the train-mode statistics are those
of the global batch, as under JAX's data mesh: the count, sum and
squared deviations go through the differentiable `global_sum`, so the
gradients are the global batch's too, and the running statistics move
alike on every rank. Every BN of the port's networks is this class.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance follows flax:
    running = (1 - momentum) * running + momentum * biased batch var, the
    batch statistics taken in float32 or wider."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if mesh.world_size() > 1:
            return self._global_batch_forward(x)
        with torch.no_grad():
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xs, dim=(0, 2, 3), unbiased=False)
            dt = self.running_mean.dtype
            self.running_mean.lerp_(mean.to(dt), self.momentum)
            self.running_var.lerp_(var.to(dt), self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the ranks' global batch: two passes in float32
        or wider (the mean, then the squared deviations from it), each one
        all-reduce, differentiable."""
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        c = xs.shape[1]
        first = mesh.global_sum(torch.cat([
            xs.sum(dim=(0, 2, 3)), xs.new_full((1,), xs.numel() // c)]))
        count = first[c]
        mean = first[:c] / count
        dev = xs - mean[None, :, None, None]
        var = mesh.global_sum((dev * dev).sum(dim=(0, 2, 3))) / count
        with torch.no_grad():
            dt = self.running_mean.dtype
            self.running_mean.lerp_(mean.detach().to(dt), self.momentum)
            self.running_var.lerp_(var.detach().to(dt), self.momentum)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = dev * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
           101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}


def num_ch_enc(num_layers: int) -> tuple[int, ...]:
    _check_layers(num_layers)
    if _BOTTLENECK[num_layers]:
        return (64, 256, 512, 1024, 2048)
    return (64, 64, 128, 256, 512)


def _check_layers(num_layers: int) -> None:
    if num_layers not in _BLOCKS:
        raise ValueError(f"ResNet{num_layers}: num_layers must be one of "
                         f"{sorted(_BLOCKS)}")


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (v1.5: the stride on the 3x3); `cout` is
    the output width, 4x the inner one."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        width = cout // 4
        self.conv1 = nn.Conv2d(cin, width, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, cout, 1, 1, bias=False)
        self.bn3 = BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class _ResNet(nn.Module):
    """torchvision's ResNet body without the classifier."""

    def __init__(self, num_layers: int, num_input_images: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3,
                               bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        block = Bottleneck if _BOTTLENECK[num_layers] else BasicBlock
        chans = num_ch_enc(num_layers)
        for stage, nb in enumerate(_BLOCKS[num_layers]):
            layer = [block(chans[stage] if b == 0 else chans[stage + 1],
                           chans[stage + 1],
                           (1 if stage == 0 else 2) if b == 0 else 1)
                     for b in range(nb)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))


class ResnetEncoder(nn.Module):
    """Returns [feat0 (H/2), feat1 (H/4), ..., feat4 (H/32)], NHWC.
    BN follows the module's mode: call `.eval()` for inference."""

    def __init__(self, num_layers: int = 18, normalize_input: bool = True,
                 num_input_images: int = 1):
        super().__init__()
        self.num_ch_enc = num_ch_enc(num_layers)
        self.normalize_input = normalize_input
        self.num_input_images = num_input_images
        self.encoder = _ResNet(num_layers, num_input_images)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if x.shape[-1] != 3 * self.num_input_images:
            raise ValueError(
                f"ResnetEncoder(num_input_images={self.num_input_images}) "
                f"expects {3 * self.num_input_images} input channels, got "
                f"{x.shape[-1]}")
        if self.normalize_input:
            x = (x - 0.45) / 0.225
        e = self.encoder
        x = F.relu(e.bn1(e.conv1(x.permute(0, 3, 1, 2))))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return [f.permute(0, 2, 3, 1) for f in feats]
