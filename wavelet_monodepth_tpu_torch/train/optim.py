"""Adam + StepLR with the reference's weight-decay groups.

Counterpart of `wavelet_monodepth_tpu/train/optim.py` (`trainer.py:
96-101`, `pyt_utils.py:12-29`): Adam(beta 0.9/0.999, eps 1e-8) with weight
decay 1e-5 added to the gradient before the moment update (torch Adam's
L2 form, which the JAX package reproduces with add_decayed_weights before
scale_by_adam). Decay applies to every parameter of the encoder and of
the pose networks (biases included: plain parameter groups in the
reference, `trainer.py:68,92-94`) and to the depth decoder's conv
weights; only the depth decoder's biases do not decay.

StepLR(step_size=15, gamma=0.1) is stepped at epoch start, so epoch k
(0-based) runs at lr0 * 0.1 ** ((k + 1) // 15); the learning rate of step
s is that of epoch s // steps_per_epoch.
"""

from __future__ import annotations

import torch


def steplr(base_lr: float, steps_per_epoch: int, step_size: int = 15,
           gamma: float = 0.1):
    """Learning rate as a function of the optimizer step count."""
    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** ((epoch + 1) // step_size)
    return schedule


def decay_groups(encoder: torch.nn.Module, decoder: torch.nn.Module,
                 pose_modules=()):
    """(decayed, not decayed) parameter lists, the JAX `_decay_mask`:
    every parameter of the encoder and of `pose_modules` (the pose
    encoder and decoder) decays; in the depth decoder all but biases."""
    decay = list(encoder.parameters())
    no_decay = []
    for name, p in decoder.named_parameters():
        (no_decay if name.endswith("bias") else decay).append(p)
    for m in pose_modules:
        decay += list(m.parameters())
    return decay, no_decay


def make_optimizer(encoder: torch.nn.Module, decoder: torch.nn.Module,
                   base_lr: float, weight_decay: float = 1e-5,
                   pose_modules=()) -> torch.optim.Adam:
    decay, no_decay = decay_groups(encoder, decoder, pose_modules)
    return torch.optim.Adam(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
