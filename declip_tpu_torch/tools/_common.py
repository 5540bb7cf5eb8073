"""Lightweight model loading for inference-time tools (port of
declip_tpu/tools/_common.py).

Builds the model and restores the newest checkpoint without a training
solver. Like the JAX version it builds from ``cfg.model.kwargs`` alone and
never reads ``precision.dtype``, so inference computes in float32.
"""

from __future__ import annotations

import glob
import os.path as osp
import re
from typing import Optional, Union

import torch
from torch import nn

from declip_tpu_torch.checkpoint import find_last_checkpoint
from declip_tpu_torch.config import parse_config
from declip_tpu_torch.convert import load_pth
from declip_tpu_torch.models import model_entry


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for a name; CUDA that is absent raises (entry points
    run on the card unless the caller asks for the CPU, and never fall
    back)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but CUDA is not "
            f"available here; pass --device cpu to run on the CPU")
    return device


JAX_CKPT_RE = re.compile(r"ckpt(?:_(\d+))?\.msgpack")


def find_jax_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest of the JAX package's ``ckpt.msgpack`` and
    ``ckpt_<step>.msgpack`` in ``ckpt_dir`` (by mtime, the step breaking a
    tie, as the JAX package picks them), or None. The file is only named,
    never read: the port does not parse flax's msgpack format."""
    found = []
    for p in glob.glob(osp.join(ckpt_dir, "ckpt*.msgpack")):
        m = JAX_CKPT_RE.fullmatch(osp.basename(p))
        if m:
            found.append((osp.getmtime(p), int(m.group(1) or 0), p))
    return max(found)[2] if found else None


def load_eval_model(config_path: str, device: Union[str, torch.device] = "cuda",
                    seed: int = 0) -> nn.Module:
    """-> the experiment's model in eval mode on ``device``, from its newest
    checkpoint under ``<config dir>/checkpoints``, or initialised from a
    seeded ``torch.Generator`` if there is none.

    A directory that holds only the JAX package's ``ckpt*.msgpack`` raises
    ``FileNotFoundError`` naming the conversion to ``ckpt.pth.tar``: serving
    random weights in place of a trained experiment would go unnoticed.

    Weights are made or loaded on the CPU and then moved, so one seed gives
    the same weights on every device."""
    device = resolve_device(device)
    cfg = parse_config(config_path)
    base = osp.dirname(cfg.get("_config_path", osp.abspath(config_path)))
    ckpt_dir = osp.join(base, "checkpoints")
    ckpt = find_last_checkpoint(ckpt_dir)
    jax_ckpt = find_jax_checkpoint(ckpt_dir) if ckpt is None else None
    if jax_ckpt is not None:
        raise FileNotFoundError(
            f"{ckpt_dir} holds the JAX package's checkpoint {jax_ckpt} and "
            f"no ckpt*.pth.tar, the format this port reads; convert it "
            f"first:\n  python -m declip_tpu.tools.convert --config "
            f"{config_path} --to_pth {jax_ckpt} --out "
            f"{osp.join(ckpt_dir, 'ckpt.pth.tar')}")
    model = model_entry({"type": cfg.model.type,
                         "kwargs": dict(cfg.model.kwargs)})
    if ckpt is not None:
        model.load_state_dict(load_pth(ckpt), strict=True)
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
