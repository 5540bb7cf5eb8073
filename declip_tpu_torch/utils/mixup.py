"""Mixup / CutMix batch augmentation (port of declip_tpu/utils/mixup.py).

Rebuilds prototype/utils/misc.py:482-532 (``mixup_data``, ``cutmix_data``,
``rand_bbox``; plumbed but disabled in the reference solvers, as in the JAX
package, which has no caller of them either). Images are ``[B, H, W, C]``.

Each function is split into its draw, from a ``torch.Generator``, and a
deterministic apply step, so that the apply steps can be held to the JAX
package's on its own draws. λ ~ Beta(α, α) is drawn as X / (X + Y) with X
and Y from Gamma(α, 1) (``torch._standard_gamma``, which takes a
generator; ``torch.distributions.Beta`` takes none), the permutation by
``torch.randperm`` and the box centre by ``torch.randint``, all on the
generator's device. α <= 0 gives λ = 1, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

Box = Tuple[int, int, int, int]


def beta_draw(generator: torch.Generator, alpha: float) -> torch.Tensor:
    """λ ~ Beta(alpha, alpha) as a float32 scalar; 1.0 where alpha <= 0."""
    if alpha <= 0:
        return torch.tensor(1.0, device=generator.device)
    conc = torch.full((2,), float(alpha), device=generator.device)
    g = torch._standard_gamma(conc, generator=generator)
    return g[0] / (g[0] + g[1])


def mixup_draw(generator: torch.Generator, batch: int, alpha: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(λ, permutation of the batch)."""
    lam = beta_draw(generator, alpha)
    perm = torch.randperm(batch, generator=generator,
                          device=generator.device)
    return lam, perm


def mixup_apply(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                perm: torch.Tensor):
    """-> (λ·x + (1 - λ)·x[perm], y, y[perm], λ)."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    perm = perm.to(x.device)
    mixed = lam * x + (1 - lam) * x[perm]
    return mixed, y, y[perm.to(y.device)], lam


def mixup_data(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
               alpha: float = 1.0):
    """Returns (mixed_x, y_a, y_b, lam)."""
    return mixup_apply(x, y, *mixup_draw(generator, x.shape[0], alpha))


def rand_bbox_draw(generator: torch.Generator, h: int, w: int
                   ) -> Tuple[int, int]:
    """The CutMix box's centre (cx in [0, w), cy in [0, h))."""
    cx = torch.randint(0, w, (), generator=generator,
                       device=generator.device)
    cy = torch.randint(0, h, (), generator=generator,
                       device=generator.device)
    return int(cx), int(cy)


def rand_bbox(h: int, w: int, lam: torch.Tensor, cx: int, cy: int) -> Box:
    """CutMix box (x1, y1, x2, y2) around (cx, cy): sides of h·√(1-λ) and
    w·√(1-λ), truncated, computed in float32 as JAX does, and clipped to
    the image."""
    cut_rat = torch.sqrt(1.0 - torch.as_tensor(lam, dtype=torch.float32))
    cut_w = int((w * cut_rat).to(torch.int32))
    cut_h = int((h * cut_rat).to(torch.int32))

    def clip(v, hi):
        return min(max(v, 0), hi)

    return (clip(cx - cut_w // 2, w), clip(cy - cut_h // 2, h),
            clip(cx + cut_w // 2, w), clip(cy + cut_h // 2, h))


def cutmix_draw(generator: torch.Generator, batch: int, h: int, w: int,
                alpha: float = 1.0):
    """(λ, permutation, box centre (cx, cy))."""
    lam, perm = mixup_draw(generator, batch, alpha)
    return lam, perm, rand_bbox_draw(generator, h, w)


def cutmix_apply(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor,
                 box: Box):
    """x: [B, H, W, C]; the box of each image replaced by its permuted
    partner's -> (mixed_x, y, y[perm], λ_adj), λ_adj = 1 - the box's share
    of the image (float32)."""
    _, h, w, _ = x.shape
    x1, y1, x2, y2 = box
    perm = perm.to(x.device)
    mixed = x.clone()
    mixed[:, y1:y2, x1:x2] = x[perm, y1:y2, x1:x2]
    area = torch.tensor(float((x2 - x1) * (y2 - y1)), device=x.device)
    lam_adj = 1.0 - area / torch.tensor(float(h * w), device=x.device)
    return mixed, y, y[perm.to(y.device)], lam_adj


def cutmix_data(generator: torch.Generator, x: torch.Tensor,
                y: torch.Tensor, alpha: float = 1.0):
    """x: [B, H, W, C]. Returns (mixed_x, y_a, y_b, lam_adjusted)."""
    _, h, w, _ = x.shape
    lam, perm, (cx, cy) = cutmix_draw(generator, x.shape[0], h, w, alpha)
    return cutmix_apply(x, y, perm, rand_bbox(h, w, lam, cx, cy))
