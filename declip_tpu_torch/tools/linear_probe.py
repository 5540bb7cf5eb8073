"""Linear-probe evaluation: a linear classifier trained on frozen image
tower features (port of declip_tpu/tools/linear_probe.py).

The reference framework is an image-classification stack at heart
(setup.py:1-27); its LINEAR augmentation preset (imagenet_dataloader.py:
100-106) exists for this protocol. The dataset is embedded once by the
frozen image tower in eval mode, and a linear head ``x @ w + b`` is trained
on the features by AdamW on softmax cross-entropy, with the JAX tool's rule
exactly: zero-initialised ``w [D, C]`` and ``b [C]``, lr 1e-3, weight decay
1e-4 on both, optax's defaults otherwise (β 0.9/0.999, eps 1e-8, decoupled
decay); ``batch_size = min(batch_size, n)``; an epoch's order is
``rng.permutation(n)`` from ``np.random.default_rng(seed)``, its short last
batch padded with the order's first rows. The result is top-1 on the
validation features.

    python -m declip_tpu_torch.tools.linear_probe --config <exp>/config.yaml \
        --meta train.txt --val-meta val.txt --root /data --epochs 10 \
        [--read-from fs|synthetic] [--device cuda|cpu]

The metafiles are the ImageNet layout, ``<file> <label>`` a line; each
image goes through ONECROP. The model loads through ``load_eval_model``
(float32) and runs on the card unless ``--device`` asks for the CPU; on a
ViT the image tower's attention is K1 there. One JSON line is printed:
``linear_probe_top1`` (percent, 2 places), ``n_train`` and ``n_val``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from declip_tpu_torch.data.dataset import ImageNetDataset
from declip_tpu_torch.data.transforms import build_common_augmentation
from declip_tpu_torch.tools._common import load_eval_model


def embed_dataset(model, dataset, batch_size: int = 128
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(features [N, D] float32, labels [N] int32) of ``dataset`` through
    ``model``'s image tower in eval mode, on the model's device."""
    device = next(model.parameters()).device
    model.eval()
    feats, labels = [], []
    n = len(dataset)
    for beg in range(0, n, batch_size):
        items = [dataset[i] for i in range(beg, min(beg + batch_size, n))]
        imgs = np.stack([np.asarray(it["image"], np.float32) for it in items])
        with torch.no_grad():
            e = model.encode_image(torch.from_numpy(imgs).to(device))
        feats.append(e.float().cpu().numpy())
        labels.extend(it["label"] for it in items)
    return np.concatenate(feats), np.asarray(labels, np.int32)


def train_probe(train_x, train_y, val_x, val_y, *, epochs: int = 10,
                lr: float = 1e-3, batch_size: int = 1024, seed: int = 0,
                device="cpu") -> Tuple[Dict[str, np.ndarray], float]:
    """-> ({"w": [D, C], "b": [C]} as numpy, top-1 in percent on the
    validation features). The features and the head live on ``device``."""
    device = torch.device(device)
    n_class = int(train_y.max()) + 1
    d = train_x.shape[1]
    w = torch.zeros(d, n_class, device=device, requires_grad=True)
    b = torch.zeros(n_class, device=device, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    x_all = torch.from_numpy(np.asarray(train_x, np.float32)).to(device)
    y_all = torch.from_numpy(np.asarray(train_y, np.int64)).to(device)

    rng = np.random.default_rng(seed)
    n = train_x.shape[0]
    batch_size = min(batch_size, n)  # small probes must still take steps
    for _ in range(epochs):
        order = rng.permutation(n)
        for beg in range(0, n, batch_size):
            idx = order[beg:beg + batch_size]
            if len(idx) < batch_size:  # the JAX tool's fixed batch shape
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            sel = torch.from_numpy(idx).to(device)
            loss = F.cross_entropy(x_all[sel] @ w + b, y_all[sel])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    params = {"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
    logits = np.asarray(val_x) @ params["w"] + params["b"]
    top1 = 100.0 * (logits.argmax(-1) == np.asarray(val_y)).mean()
    return params, float(top1)


def main(argv: Optional[List[str]] = None) -> dict:
    """The CLI -> the JSON object printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--meta", required=True)
    ap.add_argument("--val-meta", required=True)
    ap.add_argument("--root", default="")
    ap.add_argument("--read-from", default="fs")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)

    model = load_eval_model(args.config, args.device)
    aug = build_common_augmentation("ONECROP")
    train_ds = ImageNetDataset(args.root, args.meta, transform=aug,
                               read_from=args.read_from)
    val_ds = ImageNetDataset(args.root, args.val_meta, transform=aug,
                             read_from=args.read_from)
    tx_x, tx_y = embed_dataset(model, train_ds)
    vx, vy = embed_dataset(model, val_ds)
    _, top1 = train_probe(tx_x, tx_y, vx, vy, epochs=args.epochs,
                          device=args.device)
    result = {"linear_probe_top1": round(top1, 2),
              "n_train": len(tx_y), "n_val": len(vy)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
