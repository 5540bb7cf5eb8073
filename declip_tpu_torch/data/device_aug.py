"""Photometric augmentation on the device (the port's copy of
declip_tpu/data/device_aug.py).

The host ships geometry-only **uint8** crops (``build_geometry_augmentation``
in data/transforms.py: decode, random crop, resize), a quarter of the bytes
of fp32 views; the photometric half of MOCOV2 runs inside the train step on
the card: colour jitter, grayscale, Gaussian blur, horizontal flip and the
ImageNet normalisation.

The JAX package draws and applies in one function; here the two are apart:

- ``photometric_params(generator, b)`` draws each sample's factors from a
  ``torch.Generator`` on the batch's device (no host round trip);
- ``photometric_apply(images_u8, params, dtype)`` applies them, with JAX's
  ops in JAX's order on fp32 NHWC (brightness; contrast against the mean of
  the grayscale image; saturation against the per-pixel grayscale; the hue
  rotation of the YIQ plane; the grayscale gate; a separable 9-tap Gaussian
  with edge padding; the flip; the clip to [0, 1]; the normalisation; the
  cast).

So the ops are held to the JAX package's on the same parameters (JAX's
PRNG streams have no torch counterpart). Ranges and probabilities are the
reference's MOCOV2 preset (imagenet_dataloader.py:66-74), as in JAX.

Randomness is keyed like ``jax.random.fold_in``: the train step seeds one
generator per view from (seed, step, view) (``view_generator``), so a
resumed or rolled-back run draws the same parameters at the same step.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from declip_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

# YIQ conversion for the hue rotation; its inverse is taken in fp32, as
# jnp.linalg.inv does in the JAX package
_RGB2YIQ = ((0.299, 0.587, 0.114),
            (0.596, -0.274, -0.322),
            (0.211, -0.523, 0.312))
_GRAY = (0.299, 0.587, 0.114)
BLUR_RADIUS = 4

# the MOCOV2 preset's ranges and probabilities: colour jitter (brightness,
# contrast, saturation, hue) and its gate, grayscale, blur and its sigma,
# flip
_JITTER = (0.4, 0.4, 0.4, 0.1)
_P_JITTER = 0.8
_P_GRAY = 0.2
_P_BLUR = 0.5
_BLUR_SIGMA = (0.1, 2.0)
_P_FLIP = 0.5

# which views of each preset get the strong MOCOV2 photometrics; the others
# are normalised only (SLIP's base view is crop and normalise,
# STANDARD_SLIP; STANDARD_CLIP and ONECROP have no photometrics)
_PRESET_STRONG_VIEWS = {
    "MOCOV2": (True, True),
    "SIMCLR": (True, True),
    "SIMSIAM": (True, True),
    "SLIP": (False, True, True),
    "STANDARD_CLIP": (False,),
    "ONECROP": (False,),
}

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A 64-bit seed from ``key`` and ``data`` (splitmix64's finaliser over
    their combination): the role of ``jax.random.fold_in``."""
    z = (key * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def view_generator(seed: int, step: int, view: int,
                   device) -> torch.Generator:
    """The generator of view ``view`` at train step ``step`` of a run
    seeded ``seed``, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_in(fold_in(int(seed), int(step)), int(view)))
    return g


def photometric_params(generator: torch.Generator,
                       b: int) -> Dict[str, torch.Tensor]:
    """Each of ``b`` samples' draws, [b] tensors on the generator's device:
    the gates ``jitter``, ``gray``, ``blur`` and ``flip`` (bool), the
    factors ``brightness``, ``contrast``, ``saturation`` (each in
    [1 - j, 1 + j]), ``hue`` (in [-h, h], in turns) and the blur's
    ``sigma``. The factors are drawn for every sample; a closed jitter gate
    leaves them unused."""
    u = torch.rand((9, b), generator=generator, device=generator.device)
    bj, cj, sj, hj = _JITTER

    def span(row, lo, hi):
        return lo + (hi - lo) * row

    return {
        "jitter": u[0] < _P_JITTER,
        "brightness": span(u[1], 1 - bj, 1 + bj),
        "contrast": span(u[2], 1 - cj, 1 + cj),
        "saturation": span(u[3], 1 - sj, 1 + sj),
        "hue": span(u[4], -hj, hj),
        "gray": u[5] < _P_GRAY,
        "blur": u[6] < _P_BLUR,
        "sigma": span(u[7], *_BLUR_SIGMA),
        "flip": u[8] < _P_FLIP,
    }


@lru_cache(maxsize=8)
def _constants(device: torch.device) -> Dict[str, torch.Tensor]:
    """The fp32 constants on ``device``, copied there once: a copy from
    pageable memory would wait for the device's queue on every call."""
    rgb2yiq = torch.tensor(_RGB2YIQ, dtype=torch.float32)
    consts = {"rgb2yiq": rgb2yiq, "yiq2rgb": torch.linalg.inv(rgb2yiq),
              "gray": torch.tensor(_GRAY, dtype=torch.float32),
              "mean": torch.as_tensor(IMAGENET_MEAN),
              "std": torch.as_tensor(IMAGENET_STD)}
    return {k: v.to(device) for k, v in consts.items()}


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """fp32 [..., 3] -> [..., 1] luma."""
    return (x * _constants(x.device)["gray"]).sum(-1, keepdim=True)


def _blur_taps(sigma: torch.Tensor) -> torch.Tensor:
    """Per-sample 1-D Gaussian taps [B, 2 * BLUR_RADIUS + 1]."""
    t = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-(t[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    return k / k.sum(-1, keepdim=True)


def _separable_blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3]; taps: [B, K] per sample. Edge padding, then two
    depthwise convolutions (along W, then H) with one filter per sample and
    channel (groups = B*3)."""
    b, h, w, c = x.shape
    k = taps.shape[-1]
    pad = k // 2
    planes = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    weight = taps.repeat_interleave(c, dim=0)  # [B*3, K]
    planes = F.conv2d(F.pad(planes, (pad, pad, 0, 0), mode="replicate"),
                      weight.view(b * c, 1, 1, k), groups=b * c)
    planes = F.conv2d(F.pad(planes, (0, 0, pad, pad), mode="replicate"),
                      weight.view(b * c, 1, k, 1), groups=b * c)
    return planes.view(b, c, h, w).permute(0, 2, 3, 1)


def _hue_matrices(theta: torch.Tensor) -> torch.Tensor:
    """[B] angles -> [B, 3, 3]: YIQ2RGB . rot(theta) . RGB2YIQ."""
    consts = _constants(theta.device)
    cos, sin = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    rot = torch.stack([one, zero, zero,
                       zero, cos, -sin,
                       zero, sin, cos], dim=-1).view(-1, 3, 3)
    return consts["yiq2rgb"] @ rot @ consts["rgb2yiq"]


def _normalize(x: torch.Tensor) -> torch.Tensor:
    consts = _constants(x.device)
    return (x - consts["mean"]) / consts["std"]


def photometric_apply(images_u8: torch.Tensor, params: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised [B, H, W, 3] in ``dtype``, each
    sample under its own ``params`` (``photometric_params``)."""
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"photometric_apply takes uint8 crops, got "
                        f"{images_u8.dtype}")
    b, h, w, _ = images_u8.shape
    x = images_u8.float() / 255.0

    def col(name):
        return params[name].view(b, 1, 1, 1)

    apply_j = col("jitter")
    # brightness
    x = x * torch.where(apply_j, col("brightness"), 1.0)
    # contrast (torchvision: blend with the mean of the grayscale image)
    f = torch.where(apply_j, col("contrast"), 1.0)
    mean_g = _grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
    x = mean_g + f * (x - mean_g)
    # saturation (blend with the per-pixel grayscale)
    f = torch.where(apply_j, col("saturation"), 1.0)
    g = _grayscale(x)
    x = g + f * (x - g)
    # hue: rotate the IQ chroma plane
    theta = torch.where(params["jitter"], params["hue"], 0.0) * 2.0 * math.pi
    m = _hue_matrices(theta)  # [B, 3 out, 3 in]
    x = torch.matmul(x.reshape(b, h * w, 3), m.transpose(1, 2)).view(
        b, h, w, 3)
    # random grayscale
    x = torch.where(col("gray"), _grayscale(x).expand(b, h, w, 3), x)
    # gaussian blur
    blurred = _separable_blur(x, _blur_taps(params["sigma"]))
    x = torch.where(col("blur"), blurred, x)
    # horizontal flip
    x = torch.where(col("flip"), x.flip(2), x)
    x = torch.clamp(x, 0.0, 1.0)
    return _normalize(x).to(dtype)


def normalize_only(images_u8: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _normalize(images_u8.float() / 255.0).to(dtype)


def strong_views(preset: str, views: int) -> Sequence[bool]:
    """Which of ``views`` views get the strong photometrics under
    ``preset`` (every view of a preset the table does not name)."""
    strong = _PRESET_STRONG_VIEWS.get(preset, (True,) * views)
    return [v >= len(strong) or strong[v] for v in range(views)]


def augment_views(crops_u8: torch.Tensor, *, views: int,
                  preset: str = "MOCOV2", seed: int = 0, step: int = 0,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3*views] (host crops stacked on the channel axis) ->
    normalised [B, H, W, 3*views] in ``dtype``. Strong views take
    independent draws, view v from ``view_generator(seed, step, v)``; weak
    views are normalised only."""
    if crops_u8.dtype != torch.uint8:
        raise TypeError(f"augment_views takes uint8 crops, got "
                        f"{crops_u8.dtype}")
    if crops_u8.shape[-1] != 3 * views:
        raise ValueError(f"{views} views want {3 * views} channels, got "
                         f"{tuple(crops_u8.shape)}")
    outs = []
    for v, strong in enumerate(strong_views(preset, views)):
        view = crops_u8[..., 3 * v:3 * (v + 1)]
        if not strong:
            outs.append(normalize_only(view, dtype))
            continue
        gen = view_generator(seed, step, v, crops_u8.device)
        params = photometric_params(gen, view.shape[0])
        outs.append(photometric_apply(view, params, dtype))
    return torch.cat(outs, dim=-1)
