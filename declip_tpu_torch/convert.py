"""Carry weights into the port.

- :func:`state_from_jax_variables` turns the JAX package's ``{'params':
  ..., 'batch_stats': ...}`` tree, as nested dicts of numpy arrays, into
  this package's state dict: the port's own copy of the name mapping in
  declip_tpu/tools/convert.py:37-115 (transformer towers; the ResNet's
  ``layer{i}.{j}``, ``downsample.{0,1}``, BatchNorm and ``attnpool``
  names, conv kernels HWIO -> OIHW; the BatchNorm statistics as
  ``running_mean``/``running_var``, from flax's BatchNorm and from the
  grouped-statistics layout alike, both under ``BatchNorm_0``; and the
  method heads, which need no renaming: FILIP's and DeFILIP's mappings and
  shape-``()`` ``logit_scale_dense``, the SimSiam heads, SLIP's
  ``predictor_sim``); an HF text tower's ``text/backbone`` subtree from
  the Flax HF names to transformers' torch names (:func:`_hf_entry`).
- :func:`bank_from_jax` makes the port's ``BankState`` from a JAX
  ``BankState``'s arrays, so that both packages start from one bank, and
  :func:`ssl_from_jax` the port's ``MoCoState`` from a JAX ``MoCoState``
  (an ``SSLModel``'s variables map with no special case: ``head_fc1``,
  ``head.fc1`` are Linear layers here and Dense layers there).
- :func:`load_pth` reads the ``{"model": state, "last_iter": n}`` file that
  ``python -m declip_tpu.tools.convert --to_pth`` writes (the reference's
  checkpoint format).
- :func:`jax_leaves` goes the other way for a model's parameters: which
  of the port's tensors make one leaf of the JAX package's parameter tree
  and how each reads in that leaf's layout, for the optimizer statistics
  that the JAX package takes per leaf (Adafactor, LARS).

Either state goes to ``model.load_state_dict(state, strict=True)``, which
is the check that every weight carried across.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from declip_tpu_torch.models.memory_bank import BankState
from declip_tpu_torch.models.ssl_builders import MoCoState, init_moco_state

_ATTN_NAMES = (
    (".attn.qkv.kernel", ".attn.in_proj_weight"),
    (".attn.qkv.bias", ".attn.in_proj_bias"),
    (".attn.out.kernel", ".attn.out_proj.weight"),
    (".attn.out.bias", ".attn.out_proj.bias"),
)


def _torch_key(path: str, collection: str) -> str:
    if path.startswith("text."):
        path = "encode_text." + path[len("text."):]
    path = re.sub(r"\blayer(\d)_(\d+)\b", r"layer\1.\2", path)
    path = path.replace(".downsample_conv.", ".downsample.0.")
    path = path.replace(".downsample_bn.", ".downsample.1.")
    path = path.replace(".LayerNorm_0.scale", ".weight")
    path = path.replace(".LayerNorm_0.bias", ".bias")
    if collection == "batch_stats":
        path = path.replace(".BatchNorm_0.mean", ".running_mean")
        path = path.replace(".BatchNorm_0.var", ".running_var")
    else:
        path = path.replace(".BatchNorm_0.scale", ".weight")
        path = path.replace(".BatchNorm_0.bias", ".bias")
    return path.replace(".token_embedding.embedding", ".token_embedding.weight")


def _hf_entry(key: str, arr: np.ndarray):
    """One Flax HF backbone leaf -> (torch name, array): a ``kernel``
    becomes ``weight``, transposed; an ``embedding`` and a LayerNorm's
    ``scale`` become ``weight``. The transpose holds for GPT2's ``Conv1D``
    too, whose Flax kernel is [out, in] and whose torch weight is
    [in, out] (tests/test_torch_hf_text.py holds it on square ones)."""
    stem, leaf = key.rsplit(".", 1)
    if leaf == "kernel":
        return f"{stem}.weight", arr.T
    if leaf in ("embedding", "scale"):
        return f"{stem}.weight", arr
    return key, arr


def state_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a JAX model's variables tree into reference-named tensors
    (scan-stacked ``transformer.layers`` unstacked into ``resblocks.{i}``,
    Dense kernels transposed to torch's [out, in], conv kernels to
    [out, in, kh, kw])."""
    out: Dict[str, torch.Tensor] = {}

    def emit(key: str, arr: np.ndarray):
        out[key] = torch.from_numpy(np.array(arr, copy=True))

    def walk(tree: Mapping, prefix: str, collection: str):
        for name, sub in tree.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, Mapping):
                walk(sub, path, collection)
                continue
            arr = np.asarray(sub)
            if path.startswith("text.backbone."):
                emit(*_hf_entry("encode_text." + path[len("text."):], arr))
                continue
            key = _torch_key(path, collection)
            if key.endswith(".patch_embed.kernel"):
                # dense [p*p*3, W] -> conv [W, 3, p, p]
                p = int(round((arr.shape[0] / 3) ** 0.5))
                conv = arr.reshape(p, p, 3, arr.shape[1]).transpose(3, 2, 0, 1)
                emit(key.replace(".patch_embed.kernel", ".conv1.weight"), conv)
                continue
            m = re.search(r"transformer\.layers\.(.*)$", key)
            if m:
                # stacked [L, ...]: one entry per resblock
                base = key[: m.start()] + "transformer.resblocks"
                for i in range(arr.shape[0]):
                    k = f"{base}.{i}.{m.group(1)}"
                    for flax_name, torch_name in _ATTN_NAMES:
                        k = k.replace(flax_name, torch_name)
                    a = arr[i]
                    if k.endswith(".kernel"):
                        emit(k[: -len(".kernel")] + ".weight", a.T)
                    elif k.endswith((".in_proj_weight", ".out_proj.weight")):
                        emit(k, a.T)
                    else:
                        emit(k, a)
                continue
            if key.endswith(".kernel"):
                # conv HWIO -> OIHW; dense [in, out] -> [out, in]
                emit(key[: -len(".kernel")] + ".weight",
                     arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
            else:
                emit(key, arr)

    walk(variables.get("params", {}), "", "params")
    walk(variables.get("batch_stats") or {}, "", "batch_stats")
    return out


def bank_from_jax(bank, ptr, device=None) -> BankState:
    """The port's ``BankState`` from a JAX ``BankState``'s ``bank`` [size,
    dim] and ``ptr`` (arrays or numpy)."""
    return BankState(torch.from_numpy(np.array(bank, copy=True)).to(device),
                     int(np.asarray(ptr)))


def ssl_from_jax(model: nn.Module, moco_state) -> MoCoState:
    """The port's ``MoCoState`` for ``model`` (an ``SSLModel``) from a JAX
    ``MoCoState`` (arrays or numpy): the key parameters and the key
    encoder's BatchNorm statistics through
    :func:`state_from_jax_variables`, the queue and its pointer."""
    queue = np.array(moco_state.queue, dtype=np.float32, copy=True)
    state = init_moco_state(model, torch.Generator(), *queue.shape)
    state.key_model.load_state_dict(state_from_jax_variables(
        {"params": moco_state.key_params,
         "batch_stats": moco_state.key_batch_stats or {}}), strict=True)
    state.queue.copy_(torch.from_numpy(queue))
    state.queue_ptr = int(np.asarray(moco_state.queue_ptr))
    return state


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """State dict from a ``{"model": state, ...}`` .pth.tar, with a leading
    ``module.`` (DataParallel/DDP) stripped from the keys. The reference's
    BatchNorm counters (``num_batches_tracked``) are dropped: the port's
    BatchNorm, like flax's, has a fixed momentum and keeps no count."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, Mapping) or "model" not in ckpt:
        raise ValueError(f"{path}: expected a dict with a 'model' state dict")
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in ckpt["model"].items()
            if not k.endswith(".num_batches_tracked")}


@dataclass
class JaxLeaf:
    """One leaf of the JAX package's parameter tree over the port's
    parameters: ``names`` in leaf order (the resblocks ``0..L-1`` of a
    leaf that ``nn.scan`` stacks over depth, one name otherwise) and each
    one's ``layout``: ``copy``; ``t``, a Dense kernel, [out, in] here and
    [in, out] there; ``conv``, OIHW here and HWIO there; ``patch``, the
    ViT patch embedding, a conv [W, 3, p, p] here and a Dense
    [p*p*3, W] there. ``key`` names the leaf: the port's name with the
    resblock index taken out."""

    key: str
    names: List[str]
    layouts: List[str]
    stacked: bool

    def to_jax(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The leaf in the JAX layout, from the port's tensors (a copy
        where the layout or the stacking needs one)."""
        parts = [_to_jax(t, lay) for t, lay in zip(tensors, self.layouts)]
        return torch.stack(parts) if self.stacked else parts[0]

    def from_jax(self, leaf: torch.Tensor) -> List[torch.Tensor]:
        """The port's tensors (views where the layout allows) of a leaf in
        the JAX layout."""
        parts = leaf.unbind(0) if self.stacked else [leaf]
        return [_from_jax(x, lay) for x, lay in zip(parts, self.layouts)]


def _to_jax(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "t":
        return t.t()
    if layout == "conv":
        return t.permute(2, 3, 1, 0)
    if layout == "patch":  # conv [W, 3, p, p] -> dense [p*p*3, W]
        return t.permute(2, 3, 1, 0).reshape(-1, t.shape[0])
    return t


def _from_jax(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "t":
        return x.t()
    if layout == "conv":
        return x.permute(3, 2, 0, 1)
    if layout == "patch":
        p = int(round((x.shape[0] / 3) ** 0.5))
        return x.reshape(p, p, 3, x.shape[1]).permute(3, 2, 0, 1)
    return x


_RESBLOCK = re.compile(r"\.resblocks\.(\d+)\.")


def jax_leaves(model: nn.Module) -> List[JaxLeaf]:
    """The JAX parameter tree's leaves over ``model``'s parameters, in
    ``named_parameters`` order of their first tensor: the inverse of
    :func:`state_from_jax_variables` (a transformer's resblocks stacked
    back into one leaf per kind of parameter, Dense kernels transposed,
    conv kernels to HWIO, the patch embedding to its Dense [p*p*3, W])."""
    from declip_tpu_torch.models.vit import PatchEmbed

    modules = dict(model.named_modules())
    leaves: Dict[str, JaxLeaf] = {}
    for name, p in model.named_parameters():
        owner_name, _, local = name.rpartition(".")
        owner = modules[owner_name]
        if p.ndim == 4:
            layout = "patch" if isinstance(owner, PatchEmbed) else "conv"
        elif p.ndim == 2 and (isinstance(owner, nn.Linear)
                              or local == "in_proj_weight"):
            layout = "t"
        else:
            layout = "copy"
        m = _RESBLOCK.search(name)
        key = (name if m is None else
               name[:m.start()] + ".layers." + name[m.end():])
        leaf = leaves.setdefault(key, JaxLeaf(key, [], [], m is not None))
        if m is not None and int(m.group(1)) != len(leaf.names):
            raise ValueError(f"{name}: resblocks out of order")
        leaf.names.append(name)
        leaf.layouts.append(layout)
    return list(leaves.values())
