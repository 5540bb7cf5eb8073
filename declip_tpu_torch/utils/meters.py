"""Windowed/cumulative metric meters (the port's copy of
declip_tpu/utils/meters.py).

Reference: prototype/utils/misc.py:22-56 (`AverageMeter` with an allreducing
`reduce_update`). The port trains on one process, so the host-side meter is
pure Python, as in the JAX package.
"""

from __future__ import annotations

from collections import deque


class AverageMeter:
    """Tracks current value, windowed average, and global average.

    length > 0  -> moving average over the last `length` updates
    length == 0 -> cumulative average (reference semantics, misc.py:22-33)
    """

    def __init__(self, length: int = 0):
        self.length = length
        self.reset()

    def reset(self) -> None:
        if self.length > 0:
            self.history: deque = deque(maxlen=self.length)
        self.count = 0
        self.sum = 0.0
        self.val = 0.0
        self.avg = 0.0

    def update(self, val: float, num: int = 1) -> None:
        val = float(val)
        self.val = val
        if self.length > 0:
            # reference ignores num in windowed mode (misc.py:41-48)
            self.history.append(val)
            self.avg = sum(self.history) / len(self.history)
            self.count += 1  # total updates seen (spike detector warmup)
        else:
            self.sum += val * num
            self.count += num
            self.avg = self.sum / max(self.count, 1)


class MeterGroup:
    """Dict of named AverageMeters with a one-call update."""

    def __init__(self, length: int = 0):
        self.length = length
        self.meters: dict = {}

    def update(self, scalars: dict, num: int = 1) -> None:
        for k, v in scalars.items():
            if k not in self.meters:
                self.meters[k] = AverageMeter(self.length)
            self.meters[k].update(float(v), num)

    def __getitem__(self, k: str) -> AverageMeter:
        return self.meters[k]

    def __contains__(self, k: str) -> bool:
        return k in self.meters

    def summary(self) -> dict:
        return {k: m.avg for k, m in self.meters.items()}
