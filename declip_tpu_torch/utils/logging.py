"""Process-0 logging + scalar metrics writer (the port's copy of
declip_tpu/utils/logging.py).

Reference: single root logger writing <exp>/log.txt with non-rank-0 processes
silenced by a drop-all filter (prototype/utils/misc.py:73-109), plus a rank-0
tensorboardX SummaryWriter under <exp>/events/ (prototype/solver/
clip_solver.py:119-120). We keep the file/console logger and replace
tensorboard with a dependency-free JSONL scalar writer (one line per scalar:
{"step": N, "tag": ..., "value": ...}) that any dashboard can tail.

The JAX package asks ``jax.process_index()`` whether this is the main
process; here the caller passes its rank.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def create_logger(log_file: Optional[str] = None,
                  name: str = "declip_tpu_torch", level: int = logging.INFO,
                  rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    # a second Solver in the same process (resume tests, notebook reuse)
    # must log to ITS experiment's log.txt — swap the file handler rather
    # than keep appending to the first run's file
    current = {
        h.baseFilename for h in logger.handlers
        if isinstance(h, logging.FileHandler)
    }
    if logger.handlers and (
            not log_file or os.path.abspath(log_file) in current):
        return logger
    for h in list(logger.handlers):
        logger.removeHandler(h)
        if isinstance(h, logging.FileHandler):
            h.close()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"
    )
    if rank == 0:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


class ScalarWriter:
    """Scalar sink: append-only JSONL (hermetic default) + optional
    tensorboard event files.

    The reference logs through tensorboardX into ``events/``
    (clip_solver.py:119-120, 588-604); our operational surface is the JSONL
    file, but when tensorboardX (or torch's bundled SummaryWriter) is
    importable the same scalars are ALSO written as TB events into the same
    directory so existing TB tooling keeps working. ``DECLIP_TB=0``
    disables the TB sink; it is never required (zero-dep JSONL remains).

    TB tags mirror the reference's names where ours differ
    (clip_solver.py:588-604): loss->loss_train, top1->acc1_train,
    top5->acc5_train, logit_scale (exp'd in our metrics)->logit_scale_exp.
    The JSONL keeps our canonical tags."""

    # our metric key -> reference tb tag (clip_solver.py:588-604)
    _TB_ALIASES = {"loss": "loss_train", "top1": "acc1_train",
                   "top5": "acc5_train", "logit_scale": "logit_scale_exp"}

    def __init__(self, event_dir: str, enabled: bool = True):
        self.enabled = enabled
        self._f = None
        self._tb = None
        if enabled:
            os.makedirs(event_dir, exist_ok=True)
            self._f = open(os.path.join(event_dir, "scalars.jsonl"), "a")
            if os.environ.get("DECLIP_TB", "1") != "0":
                self._tb = self._make_tb(event_dir)

    @staticmethod
    def _make_tb(event_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except Exception:  # noqa: BLE001 — optional dep, JSONL suffices
                return None
        try:
            return SummaryWriter(event_dir)
        except Exception:  # noqa: BLE001
            return None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._f is None:
            return
        self._f.write(
            json.dumps({"t": round(time.time(), 3), "step": int(step),
                        "tag": tag, "value": float(value)}) + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(self._TB_ALIASES.get(tag, tag),
                                float(value), int(step))

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
