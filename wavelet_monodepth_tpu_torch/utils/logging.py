"""TensorBoard scalars and the console's training line.

Counterpart of `wavelet_monodepth_tpu/utils/logging.py` for the scalars
(`trainer.py:141-143,202-226`): `SummaryLogger` writes train/val scalars
with tensorboardX and is a no-op without it; `TrainTimer` formats the
reference's progress line. The image, histogram and wavelet visuals wait
for a later slice.
"""

from __future__ import annotations

import os
import time
from typing import Dict


class SummaryLogger:
    """Separate train/val writers; a no-op if tensorboardX is missing."""

    def __init__(self, log_path: str, modes=("train", "val")):
        self.writers = {}
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        for m in modes:
            self.writers[m] = SummaryWriter(os.path.join(log_path, m))

    def scalars(self, mode: str, scalars: Dict[str, float], step: int):
        w = self.writers.get(mode)
        if w is None:
            return
        for k, v in scalars.items():
            w.add_scalar(str(k), float(v), step)

    def close(self):
        for w in self.writers.values():
            w.close()


def sec_to_hm_str(t: float) -> str:
    """`KITTI/utils.py:37-48`."""
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"


class TrainTimer:
    """The reference's progress line. examples/s is the windowed wall
    rate (steps since the previous line over the wall time since then):
    steps are queued on the card without a sync, so a per-step duration
    measures the enqueue, not the step."""

    def __init__(self, num_total_steps: int):
        self.start_time = time.time()
        self.num_total_steps = num_total_steps
        self._last_log_time = self.start_time
        self._last_log_step = 0

    def log_line(self, epoch: int, batch_idx: int, step: int,
                 batch_size: int, durations: Dict[str, float],
                 loss: float) -> str:
        now = time.time()
        dsteps = max(step - self._last_log_step, 1)
        samples_per_sec = (batch_size * dsteps
                           / max(now - self._last_log_time, 1e-9))
        self._last_log_time, self._last_log_step = now, step
        elapsed = now - self.start_time
        left = (self.num_total_steps / step - 1.0) * elapsed if step else 0
        return (f"epoch {epoch:>3} | batch {batch_idx:>6} | "
                f"forward: {durations.get('batch_process', 0):2.1f}s "
                f"(examples/s: {samples_per_sec:5.1f}) | "
                f"dataloading: {durations.get('dataloading', 0):2.1f}s | "
                f"loss: {loss:.5f} | elapsed: {sec_to_hm_str(elapsed)} | "
                f"left: {sec_to_hm_str(left)}")
