"""Parameter classification for per-group optimizer overrides (port of
declip_tpu/optim/param_groups.py).

Rebuilds prototype/utils/misc.py:267-412 (``param_group_all``): every
parameter is classified into a group key (bn_w/bn_b/ln_w/ln_b/conv_b/
linear_b/logit_scale/default) and the config's ``pconfig`` applies
per-group overrides (in practice: weight_decay 0 for norms, biases and
logit_scale). Classification walks the torch modules, as the reference does;
the groups equal those the JAX package finds on the same parameters by
flax path (param_groups.py:18-32).
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.nn.modules.conv import _ConvNd

from declip_tpu_torch.models.layers import BatchNorm


def classify_param(module: nn.Module, param_name: str) -> str:
    """Group of ``module``'s own parameter ``param_name``."""
    if "logit_scale" in param_name or "logit_bias" in param_name:
        # logit_bias (the SigLIP pairwise-loss bias) rides the logit_scale
        # group so existing zero-wd pconfigs cover it
        return "logit_scale"
    if isinstance(module, (_BatchNorm, BatchNorm)):
        # the port's BatchNorm (flax semantics) is no _BatchNorm subclass
        return "bn_w" if param_name == "weight" else "bn_b"
    if isinstance(module, nn.LayerNorm):
        return "ln_w" if param_name == "weight" else "ln_b"
    if param_name.endswith("bias"):
        # attention's in_proj_bias is a bare Parameter, a dense bias all
        # the same (the JAX package's attn/qkv/bias)
        return "conv_b" if isinstance(module, _ConvNd) else "linear_b"
    return "default"


def group_labels(model: nn.Module) -> Dict[str, str]:
    """``{parameter name: group}`` in ``model.named_parameters()`` order."""
    labels = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            labels[full] = classify_param(module, p_name)
    return {name: labels[name] for name, _ in model.named_parameters()}


def weight_decay_masks(labels: Dict[str, str], pconfig: Optional[Dict]
                       ) -> Dict[Optional[float], Set[str]]:
    """Map weight_decay value -> names of the params overridden to it.

    Groups absent from pconfig keep the optimizer's default decay (names
    under key None)."""
    overrides: Dict[str, float] = {}
    for group, sub in (pconfig or {}).items():
        if isinstance(sub, dict) and "weight_decay" in sub:
            overrides[group] = float(sub["weight_decay"])
    by_value: Dict[Optional[float], Set[str]] = {}
    for v in sorted(set(overrides.values())):
        groups = {g for g, val in overrides.items() if val == v}
        by_value[v] = {n for n, g in labels.items() if g in groups}
    by_value[None] = {n for n, g in labels.items() if g not in overrides}
    return by_value


def path_prefix_mask(names, prefixes: Tuple[str, ...]) -> Dict[str, bool]:
    """True where any dotted component of the parameter name is one of
    ``prefixes`` — used for conv1 freezing (``frozen_param_paths``)."""
    return {n: any(part in prefixes for part in n.split(".")) for n in names}
