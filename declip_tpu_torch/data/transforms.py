"""Host-side image augmentation (PIL + numpy; the port's copy of
declip_tpu/data/transforms.py).

Rebuilds prototype/data/imagenet_dataloader.py:14-150's named pipelines and
prototype/data/transforms.py's custom ops. Output convention is HWC float32,
ImageNet-normalized, the layout the port's towers take. Multi-view
transforms concatenate on the channel axis: TwoCrops -> 6ch
(transforms.py:32-41), SLIP -> 9ch base+2 strong views (slip.py:248).

Every random op draws from the ``rng`` it is given, by default the
module-global ``random`` stream (``_ModuleRng``), as in the JAX package:
with thread workers, which image gets which crop varies from run to run.
Tests pass an explicit ``random.Random(seed)``.

``build_geometry_augmentation`` gives the geometry-only uint8 variants of
the presets for the on-device path (data/device_aug.py does the rest on the
card); AutoAugment and CLSA's views have none, as in the JAX package.
``AUTOAUG`` and ``CLSA<n>[-r-r...|-lo_hi]`` take their ops from
transforms_extra.py; CLSA's transform returns a list of views, two 224 px
weak views and one strong view per resolution, which the loader collates
(data/dataloader.py).
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


class _ModuleRng:
    """Picklable stand-in for the ``random`` module.

    Transforms default their rng to the module-global stream; storing the
    module object itself makes the transform unpicklable, which breaks
    explicit ``transform=`` overrides (the device-aug geometry path) under
    ``worker_type: process`` loader workers. This delegates every call to
    the module and pickles as a fresh delegate."""

    def __getattr__(self, name):
        return getattr(random, name)

    def __reduce__(self):
        return (_ModuleRng, ())


_MODULE_RNG = _ModuleRng()

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

Transform = Callable[[Image.Image], np.ndarray]


def to_normalized_array(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class Compose:
    def __init__(self, ops: Sequence[Callable]):
        self.ops = list(ops)

    def __call__(self, x):
        for op in self.ops:
            x = op(x)
        return x


class RandomResizedCrop:
    """torchvision-equivalent RandomResizedCrop (scale/ratio sampling)."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 rng: Optional[random.Random] = None):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = self.rng.uniform(*self.scale) * area
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(self.rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = self.rng.randint(0, w - cw)
                y = self.rng.randint(0, h - ch)
                return img.resize(
                    (self.size, self.size), Image.BILINEAR,
                    box=(x, y, x + cw, y + ch),
                )
        # fallback: center crop of the limiting side
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        x, y = (w - cw) // 2, (h - ch) // 2
        return img.resize((self.size, self.size), Image.BILINEAR,
                          box=(x, y, x + cw, y + ch))


class RandomCropMinSize:
    """Resize-free square crop of the minimum side then resize
    (prototype/data/transforms.py:134-158, the CLIP training crop)."""

    def __init__(self, size: int, rng: Optional[random.Random] = None):
        self.size = size
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        if w < h:
            j, i, side = 0, self.rng.randint(0, int(round(h - w))), w
        elif h < w:
            j, i, side = self.rng.randint(0, int(round(w - h))), 0, h
        else:
            i = j = 0
            side = w
        return img.resize((self.size, self.size), Image.BILINEAR,
                          box=(j, i, j + side, i + side))


class Resize:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        if w < h:
            nw, nh = self.size, int(round(self.size * h / w))
        else:
            nw, nh = int(round(self.size * w / h)), self.size
        return img.resize((nw, nh), Image.BILINEAR)


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        x = max((w - self.size) // 2, 0)
        y = max((h - self.size) // 2, 0)
        return img.crop((x, y, x + self.size, y + self.size))


class RandomHorizontalFlip:
    def __init__(self, p=0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.rng.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class ColorJitter:
    """brightness/contrast/saturation/hue jitter (torchvision semantics)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng: Optional[random.Random] = None):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        ops = []
        if self.b:
            f = self.rng.uniform(max(0, 1 - self.b), 1 + self.b)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.c:
            f2 = self.rng.uniform(max(0, 1 - self.c), 1 + self.c)
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
        if self.s:
            f3 = self.rng.uniform(max(0, 1 - self.s), 1 + self.s)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
        if self.h:
            d = self.rng.uniform(-self.h, self.h)

            def hue_op(im, d=d):
                hsv = np.asarray(im.convert("HSV"), np.uint8).copy()
                hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                               + int(d * 255)) % 256
                return Image.fromarray(hsv, "HSV").convert("RGB")

            ops.append(hue_op)
        self.rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class RandomApply:
    def __init__(self, op, p: float, rng: Optional[random.Random] = None):
        self.op = op
        self.p = p
        self.rng = rng or _MODULE_RNG

    def __call__(self, img):
        return self.op(img) if self.rng.random() < self.p else img


class RandomGrayscale:
    def __init__(self, p=0.2, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.rng.random() < self.p:
            return img.convert("L").convert("RGB")
        return img


class GaussianBlur:
    """SimCLR blur, sigma ~ U[.1, 2.] (transforms.py:82-91)."""

    def __init__(self, sigma=(0.1, 2.0), rng: Optional[random.Random] = None):
        self.sigma = sigma
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        s = self.rng.uniform(*self.sigma)
        return img.filter(ImageFilter.GaussianBlur(radius=s))


class Cutout:
    """Randomly zero n_holes square patches (transforms.py:94-120). Runs on
    the normalized float array at the end of a pipeline, so a zeroed pixel is
    the dataset mean — same semantics as the reference's post-normalize
    tensor masking."""

    def __init__(self, n_holes: int = 2, length: int = 32, prob: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.n_holes = n_holes
        self.length = length
        self.prob = prob
        self.rng = rng or _MODULE_RNG

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if self.rng.random() >= self.prob:
            return arr
        arr = arr.copy()
        h, w = arr.shape[:2]
        half = self.length // 2
        for _ in range(self.n_holes):
            y = self.rng.randrange(h)
            x = self.rng.randrange(w)
            arr[max(0, y - half):min(h, y + half),
                max(0, x - half):min(w, x + half)] = 0.0
        return arr


class MultiView:
    """Apply k transforms and concat channel-wise (HWC)."""

    def __init__(self, transforms_: Sequence[Transform]):
        self.transforms = list(transforms_)

    def __call__(self, img: Image.Image) -> np.ndarray:
        return np.concatenate([t(img) for t in self.transforms], axis=-1)


def _mocov2_ops(size: int, rng) -> List[Callable]:
    return [
        RandomResizedCrop(size, scale=(0.2, 1.0), rng=rng),
        RandomApply(ColorJitter(0.4, 0.4, 0.4, 0.1, rng=rng), p=0.8, rng=rng),
        RandomGrayscale(p=0.2, rng=rng),
        RandomApply(GaussianBlur(rng=rng), p=0.5, rng=rng),
        RandomHorizontalFlip(rng=rng),
        to_normalized_array,
    ]


class GeometryCrop:
    """Geometry-only op for the on-device pipeline: random-resized crop to
    uint8 HWC (the photometrics happen on the card, data/device_aug.py)."""

    def __init__(self, size: int = 224, scale=(0.2, 1.0),
                 rng: Optional[random.Random] = None):
        self.crop = RandomResizedCrop(size, scale=scale, rng=rng)

    def __call__(self, img: Image.Image) -> np.ndarray:
        return np.asarray(self.crop(img), np.uint8)


class GeometryUint8:
    """Compose stages -> uint8 array. A named class (not a closure) so the
    transform pickles into ``worker_type: process`` loader workers."""

    def __init__(self, *stages):
        self.stages = stages

    def __call__(self, img):
        for s in self.stages:
            img = s(img)
        return np.asarray(img, np.uint8)


def build_geometry_augmentation(
    aug_type: str, rng: Optional[random.Random] = None
) -> Transform:
    """uint8 multi-view geometry for the on-device augmentation. Crop
    scales mirror the named presets; the photometric parameters live in
    data/device_aug.py."""
    rng = rng or _MODULE_RNG
    if aug_type in ("MOCOV2", "SIMCLR", "SIMSIAM"):
        g = GeometryCrop(224, (0.2, 1.0), rng)
        return MultiView([g, g])
    if aug_type == "STANDARD_CLIP":
        return GeometryUint8(RandomCropMinSize(224, rng=rng))
    if aug_type == "SLIP":
        base = GeometryCrop(224, (0.5, 1.0), rng)
        strong = GeometryCrop(224, (0.2, 1.0), rng)
        return MultiView([base, strong, strong])
    if aug_type.startswith("ONECROP"):
        size = int(aug_type[7:] or 224)
        return GeometryUint8(Resize(256 if size <= 256 else size),
                             CenterCrop(size))
    raise KeyError(f"no geometry variant for {aug_type!r}")


def build_common_augmentation(
    aug_type: str, rng: Optional[random.Random] = None
) -> Transform:
    """Named pipelines, parameter-for-parameter with the reference
    (imagenet_dataloader.py:14-150)."""
    rng = rng or _MODULE_RNG
    if aug_type in ("STANDARD", "STANDARD256", "LINEAR"):
        size = 256 if aug_type.endswith("256") else 224
        ops = [
            RandomResizedCrop(size, rng=rng),
            RandomHorizontalFlip(rng=rng),
        ]
        if aug_type != "LINEAR":
            ops.append(ColorJitter(0.2, 0.2, 0.2, 0.1, rng=rng))
        ops.append(to_normalized_array)
        return Compose(ops)
    if aug_type == "STANDARD_SLIP":
        return Compose([
            RandomResizedCrop(224, scale=(0.5, 1.0), rng=rng),
            to_normalized_array,
        ])
    if aug_type == "STANDARD_CLIP":
        return Compose([RandomCropMinSize(224, rng=rng), to_normalized_array])
    if aug_type in ("MOCOV1",):
        ops = [
            RandomResizedCrop(224, scale=(0.2, 1.0), rng=rng),
            RandomGrayscale(p=0.2, rng=rng),
            ColorJitter(0.4, 0.4, 0.4, 0.4, rng=rng),
            RandomHorizontalFlip(rng=rng),
            to_normalized_array,
        ]
        base = Compose(ops)
        return MultiView([base, base])
    if aug_type in ("MOCOV2", "SIMCLR", "SIMSIAM", "MOCOV2_256"):
        size = 256 if aug_type.endswith("256") else 224
        base = Compose(_mocov2_ops(size, rng))
        return MultiView([base, base])
    if aug_type == "SLIP":
        base = build_common_augmentation("STANDARD_SLIP", rng)
        strong = Compose(_mocov2_ops(224, rng))
        return MultiView([base, strong, strong])
    if aug_type in ("ONECROP", "ONECROP256", "ONECROP384"):
        crop = {"ONECROP": 224, "ONECROP256": 256, "ONECROP384": 384}[aug_type]
        resize = 256 if crop <= 256 else 384
        return Compose([Resize(resize), CenterCrop(crop), to_normalized_array])
    if aug_type == "AUTOAUG":
        from declip_tpu_torch.data.transforms_extra import ImageNetPolicy

        return Compose([
            RandomResizedCrop(224, rng=rng),
            ImageNetPolicy(rng=rng),
            RandomHorizontalFlip(rng=rng),
            to_normalized_array,
        ])
    if aug_type.startswith("CLSA"):
        # 'CLSA5-16-24-32' (the strong views' resolutions) or 'CLSA5-16_32'
        # (one resolution drawn from the range, once, here) —
        # imagenet_dataloader.py:84-96, 133-150
        from declip_tpu_torch.data.transforms_extra import CLSAAug

        head, *res_spec = aug_type[4:].split("-")
        num_times = int(head or 5)
        if res_spec and "_" in res_spec[0]:
            lo, hi = (int(e) for e in res_spec[0].split("_"))
            resolutions = [rng.choice(range(lo, hi + 1))]
        elif res_spec:
            resolutions = [int(e) for e in res_spec]
        else:
            resolutions = [96, 128, 160, 192, 224]
        base = Compose(_mocov2_ops(224, rng))
        strong = Compose([CLSAAug(num_of_times=num_times, rng=rng),
                          to_normalized_array])
        return CLSAMultiResolutionTransform(base, strong, resolutions, rng)
    raise KeyError(f"undefined augmentation type {aug_type!r}")


class CLSAMultiResolutionTransform:
    """Two MoCo-v2 weak views and one strong view per resolution, each
    cropped at its own size (transforms.py:56-80,
    CALSMultiResolutionTransform): a list, since the views' sizes differ
    and cannot share a channel axis."""

    def __init__(self, base: Transform, strong: Transform,
                 resolutions: Sequence[int],
                 rng: Optional[random.Random] = None):
        self.base = base
        self.strong = strong
        self.crops = [RandomResizedCrop(r, scale=(0.2, 1.0), rng=rng)
                      for r in resolutions]

    def __call__(self, img: Image.Image) -> List[np.ndarray]:
        views = [self.base(img), self.base(img)]
        views.extend(self.strong(crop(img)) for crop in self.crops)
        return views


class Normalize:
    """mean/std normalize on a float HWC array (list-style configs carry
    explicit mean/std kwargs)."""

    def __init__(self, mean=None, std=None):
        self.mean = np.asarray(
            IMAGENET_MEAN if mean is None else mean, np.float32)
        self.std = np.asarray(IMAGENET_STD if std is None else std, np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (np.asarray(arr, np.float32) - self.mean) / self.std


class AdjustGamma:
    """Fixed gamma correction (transforms.py AdjustGamma)."""

    def __init__(self, gamma: float = 1.0, gain: float = 1.0):
        self.gamma = gamma
        self.gain = gain

    def __call__(self, img: Image.Image) -> Image.Image:
        arr = np.asarray(img, np.float32) / 255.0
        arr = 255.0 * np.clip(self.gain * arr ** self.gamma, 0.0, 1.0)
        return Image.fromarray(arr.astype(np.uint8), img.mode)


class ToGrayscale:
    def __init__(self, num_output_channels: int = 3):
        self.n = num_output_channels

    def __call__(self, img: Image.Image) -> Image.Image:
        g = img.convert("L")
        return g.convert("RGB") if self.n == 3 else g


class RandomVerticalFlip:
    def __init__(self, p=0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.rng.random() < self.p:
            return img.transpose(Image.FLIP_TOP_BOTTOM)
        return img


class RandomRotation:
    def __init__(self, degrees, rng: Optional[random.Random] = None):
        self.degrees = ((-degrees, degrees)
                        if np.isscalar(degrees) else tuple(degrees))
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        return img.rotate(self.rng.uniform(*self.degrees))


class RandomOrientationRotation:
    """Rotate by one of a fixed set of angles (transforms.py
    RandomOrientationRotation)."""

    def __init__(self, angles: Sequence[float] = (0, 90, 180, 270),
                 rng: Optional[random.Random] = None):
        self.angles = list(angles)
        self.rng = rng or _MODULE_RNG

    def __call__(self, img: Image.Image) -> Image.Image:
        return img.rotate(self.rng.choice(self.angles))


def _to_float_array(img) -> np.ndarray:
    # the reference's ToTensor minus the CHW transpose (the towers take NHWC)
    return np.asarray(img, np.float32) / 255.0


TRANSFORM_TABLE = {
    "resize": Resize,
    "center_crop": CenterCrop,
    "random_resized_crop": RandomResizedCrop,
    "random_horizontal_flip": RandomHorizontalFlip,
    # the reference's typo'd key (transforms.py:165) kept for config parity
    "ramdom_vertical_flip": RandomVerticalFlip,
    "random_vertical_flip": RandomVerticalFlip,
    "random_rotation": RandomRotation,
    "color_jitter": ColorJitter,
    "normalize": Normalize,
    "to_tensor": lambda: _to_float_array,
    "adjust_gamma": AdjustGamma,
    "to_grayscale": ToGrayscale,
    "cutout": Cutout,
    "random_orientation_rotation": RandomOrientationRotation,
    "gaussian_blur": GaussianBlur,
}


def build_transformer(cfgs: Sequence, image_reader: Optional[dict] = None
                      ) -> Transform:
    """List-style transform configs ``[{type, kwargs}, ...]``
    (transforms.py:160-210 build_transformer). The image_reader arg is
    accepted for config parity; the kestrel GPU path it selected is
    SenseTime-hardware-specific (the native decode path is selected at the
    dataset level here)."""
    ops = []
    for cfg in cfgs:
        ctor = TRANSFORM_TABLE[cfg["type"]]
        ops.append(ctor(**(cfg.get("kwargs") or {})))
    return Compose(ops)
