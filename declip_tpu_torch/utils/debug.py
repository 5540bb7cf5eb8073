"""Crash-time diagnostics (port of declip_tpu/utils/debug.py).

Replaces the reference's ipdb-on-exception hook (prototype/solver/
crash_on_ipy.py:1-13) with a non-interactive equivalent for headless jobs:
faulthandler tracebacks for hard crashes, and an excepthook that writes a
structured report (time, exception, traceback, argv, devices, the
process's rank) to ``crash_report.json``, with the JAX package's keys.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import time
import traceback
from typing import List, Optional


def _devices() -> List[str]:
    """The visible CUDA devices by index and name, or ``["cpu"]``."""
    import torch

    if not torch.cuda.is_available():
        return ["cpu"]
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())]


def install_crash_handler(dump_dir: Optional[str] = None) -> None:
    faulthandler.enable()
    dump_dir = dump_dir or os.getcwd()

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(dump_dir, "crash_report.json")
            info = {
                "time": time.strftime("%Y-%m-%d %H:%M:%S"),
                "type": exc_type.__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(exc_type, exc, tb),
                "argv": sys.argv,
            }
            # a crash inside CUDA can make these raise in turn: the report
            # is written without them then
            try:
                from declip_tpu_torch.parallel import dist

                info["devices"] = _devices()
                info["process_index"] = dist.rank()
            except Exception:
                pass
            with open(path, "w") as f:
                json.dump(info, f, indent=2)
            sys.stderr.write(f"[declip_tpu_torch] crash report: {path}\n")
        finally:
            prev_hook(exc_type, exc, tb)

    sys.excepthook = hook
