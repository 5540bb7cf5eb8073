"""AutoAugment (ImageNet policy) and CLSA repeated strong augmentation
(the port's copy of declip_tpu/data/transforms_extra.py).

Rebuilds prototype/data/auto_augmentation.py (the standard public 24
sub-policy ImageNet AutoAugment table) and prototype/data/
clsa_augmentation.py (RandAugment-style repeated strong augmentation) with
PIL + numpy: the same PIL calls drawing from the same ``random.Random`` in
the same order as the JAX package's, so that one seed gives the same
images, bit for bit.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

from PIL import Image, ImageEnhance, ImageOps

from declip_tpu_torch.data.transforms import _MODULE_RNG

# ---------------------------------------------------------------------------
# atomic ops, each taking (img, magnitude) with magnitude in [0, 9]
# ---------------------------------------------------------------------------


def _shear_x(img, v):
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, v):
    return img.transform(img.size, Image.AFFINE, (1, 0, v * img.size[0], 0, 1, 0))


def _translate_y(img, v):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v * img.size[1]))


OPS = {
    "ShearX": (_shear_x, 0.0, 0.3),
    "ShearY": (_shear_y, 0.0, 0.3),
    "TranslateX": (_translate_x, 0.0, 150 / 331),
    "TranslateY": (_translate_y, 0.0, 150 / 331),
    "Rotate": (lambda im, v: im.rotate(v), 0.0, 30.0),
    "Color": (lambda im, v: ImageEnhance.Color(im).enhance(1 + v), 0.0, 0.9),
    "Posterize": (lambda im, v: ImageOps.posterize(im, int(v)), 8, 4),
    "Solarize": (lambda im, v: ImageOps.solarize(im, int(v)), 256, 0),
    "Contrast": (lambda im, v: ImageEnhance.Contrast(im).enhance(1 + v), 0.0, 0.9),
    "Sharpness": (lambda im, v: ImageEnhance.Sharpness(im).enhance(1 + v), 0.0, 0.9),
    "Brightness": (lambda im, v: ImageEnhance.Brightness(im).enhance(1 + v), 0.0, 0.9),
    "AutoContrast": (lambda im, v: ImageOps.autocontrast(im), 0, 0),
    "Equalize": (lambda im, v: ImageOps.equalize(im), 0, 0),
    "Invert": (lambda im, v: ImageOps.invert(im), 0, 0),
}

# the public ImageNet AutoAugment policy: 24 (op, prob, magnitude) pairs
IMAGENET_POLICY: Sequence[Tuple[Tuple[str, float, int], Tuple[str, float, int]]] = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
]


def _apply(img: Image.Image, name: str, prob: float, magnitude: int,
           rng: random.Random) -> Image.Image:
    if rng.random() > prob:
        return img
    fn, lo, hi = OPS[name]
    v = lo + (hi - lo) * magnitude / 9.0
    # geometric AND enhancement ops flip sign with p=0.5 (the reference's
    # 1 +/- 0.1*m enhance factors, auto_augmentation.py): enhance(1+v) with
    # v in [-0.9, 0.9] symmetric
    if name in ("ShearX", "ShearY", "Rotate", "TranslateX", "TranslateY",
                "Color", "Contrast", "Sharpness", "Brightness"):
        if rng.random() < 0.5:
            v = -v
    return fn(img, v)


class ImageNetPolicy:
    """AutoAugment ImageNet policy (auto_augmentation.py:49)."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        p1, p2 = self.rng.choice(IMAGENET_POLICY)
        img = _apply(img, *p1, self.rng)
        img = _apply(img, *p2, self.rng)
        return img


class CLSAAug:
    """Repeated random strong augmentation (clsa_augmentation.py:187):
    apply ``num_of_times`` randomly chosen ops at random magnitudes."""

    def __init__(self, num_of_times: int = 5,
                 rng: Optional[random.Random] = None):
        self.n = num_of_times
        self.rng = rng or _MODULE_RNG
        self.names: List[str] = list(OPS)

    def __call__(self, img: Image.Image) -> Image.Image:
        times = self.rng.randint(0, self.n)
        for _ in range(times):
            name = self.rng.choice(self.names)
            img = _apply(img, name, 1.0, self.rng.randint(0, 9), self.rng)
        return img
