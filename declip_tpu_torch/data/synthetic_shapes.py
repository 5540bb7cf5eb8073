"""Procedural learnable image-text data: colored shapes with captions (the
port's own copy of declip_tpu/data/synthetic_shapes.py, numpy only).

A 16-class dataset ("a {color} {shape}" over 4 colors x 4 shapes) whose
captions describe generable image attributes, with position/size/shade
jitter so exact-pixel memorization is impossible: above-chance zero-shot
needs aligned image and text features. The reference's operational check
("the run converges", clip_solver.py:675-737) as a deterministic, hermetic
dataset, which ``python -m declip_tpu_torch.tools.learnability`` trains on.
On the same ``np.random.Generator`` every function gives what the JAX
package's gives, bit for bit (tests/test_torch_tools_extra.py).

The plain-noise ``synthetic`` storage backend (data/dataset.py) is for
plumbing and throughput; this module is for learning.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

COLORS = {
    "red": (1.0, 0.1, 0.1),
    "green": (0.1, 1.0, 0.1),
    "blue": (0.2, 0.3, 1.0),
    "yellow": (1.0, 1.0, 0.1),
}
SHAPES = ("square", "circle", "triangle", "cross")
CLASSES: List[Tuple[str, str]] = [(c, s) for c in COLORS for s in SHAPES]


def render(rng: np.random.Generator, color: str, shape: str,
           res: int = 32) -> np.ndarray:
    """One [res, res, 3] float32 rendering with position/size/shade jitter."""
    img = np.zeros((res, res, 3), np.float32)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    lo, hi = max(3, res * 5 // 32), max(4, res * 9 // 32)
    r = rng.integers(lo, hi)  # half-size jitter
    cy, cx = rng.integers(r + 1, res - r - 1, 2)
    yy, xx = np.mgrid[0:res, 0:res]
    if shape == "square":
        mask = (abs(yy - cy) <= r) & (abs(xx - cx) <= r)
    elif shape == "circle":
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    elif shape == "triangle":
        mask = (yy >= cy - r) & (yy <= cy + r) & (
            abs(xx - cx) <= (yy - (cy - r)) / 2)
    else:  # cross
        mask = ((abs(yy - cy) <= r) & (abs(xx - cx) <= 2)) | (
            (abs(xx - cx) <= r) & (abs(yy - cy) <= 2))
    shade = rng.uniform(0.6, 1.0)
    for ch, v in enumerate(COLORS[color]):
        img[..., ch][mask] = v * shade
    return img


def render_class_batch(rng: np.random.Generator, n: int,
                       res: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """(images [n, res, res, 3], class indices [n]) for a uniform draw."""
    idx = rng.integers(0, len(CLASSES), n)
    imgs = np.stack([render(rng, *CLASSES[i], res=res) for i in idx])
    return imgs, idx


def captions(idx: np.ndarray, template: str = "a {} {}") -> List[str]:
    return [template.format(c, s) for c, s in (CLASSES[i] for i in idx)]


def class_prompts(template: str = "a {} {}") -> List[str]:
    """The 16 zero-shot classifier prompts, in CLASSES order."""
    return [template.format(c, s) for c, s in CLASSES]
