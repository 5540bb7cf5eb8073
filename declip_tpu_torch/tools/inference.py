"""Zero-shot inference over a directory of images, with saliency maps (port
of declip_tpu/tools/inference.py).

    python -m declip_tpu_torch.tools.inference --config <exp>/config.yaml \
        --image_dir /path/to/images --classes "cat,dog,car" \
        [--out results.jsonl] [--saliency] [--device cuda|cpu]

Each class embedding averages two prompts ("a photo of a {c}." and "a photo
of the {c}."), normalised before and after; each image goes through
ONECROP, and its class probabilities are ``softmax(100 * logits)`` of the
normalised image embedding against them. One JSONL record an image:
``filename``, ``prediction``, ``probs`` (rounded to 6 digits) and, with
``--saliency``, the path of ``<image>.saliency.npy``: the gradient of the
top class's similarity with respect to the input pixels, its absolute
value's max over the channels, ``[H, W]`` float32. On a ViT on the card
that backward runs K2 in fp32 (ops/flash_attention.py).

The model loads from the experiment's newest ``checkpoints/ckpt*.pth.tar``
(seeded random weights where there is none) and computes in float32, on
the card unless ``--device`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from declip_tpu_torch.data.dataset import pil_loader
from declip_tpu_torch.data.transforms import build_common_augmentation
from declip_tpu_torch.tokenizer import get_tokenizer
from declip_tpu_torch.tools._common import load_eval_model

__all__ = ["PROMPTS", "class_embeddings", "main"]

PROMPTS = ("a photo of a {}.", "a photo of the {}.")
EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def class_embeddings(model, classes: List[str],
                     device: torch.device) -> torch.Tensor:
    """``[C, D]``: each class's prompts encoded, normalised, averaged and
    normalised again."""
    texts = [p.format(c) for c in classes for p in PROMPTS]
    tokens = torch.from_numpy(np.asarray(get_tokenizer().tokenize(texts),
                                         np.int64)).to(device)
    with torch.no_grad():
        emb = _unit(model.encode_text(tokens))
    return _unit(emb.reshape(len(classes), len(PROMPTS), -1).mean(dim=1))


def main(argv: Optional[List[str]] = None) -> str:
    """The CLI -> the path of the JSONL written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--classes", required=True,
                    help="comma-separated class names")
    ap.add_argument("--out", default="inference_results.jsonl")
    ap.add_argument("--saliency", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)

    model = load_eval_model(args.config, args.device).requires_grad_(False)
    device = next(model.parameters()).device
    classes = [c.strip() for c in args.classes.split(",")]
    class_emb = class_embeddings(model, classes, device)
    transform = build_common_augmentation("ONECROP")
    paths = sorted(p for p in glob.glob(os.path.join(args.image_dir, "*"))
                   if p.lower().endswith(EXTENSIONS))

    def similarities(img: torch.Tensor) -> torch.Tensor:
        """``[1, H, W, 3]`` -> ``[C]`` cosine similarities."""
        return (_unit(model.encode_image(img)) @ class_emb.T)[0]

    with open(args.out, "w") as f:
        for path in paths:
            with open(path, "rb") as imf:
                img = np.asarray(transform(pil_loader(imf.read())),
                                 np.float32)[None]
            x = torch.from_numpy(img).to(device)
            with torch.no_grad():
                probs = torch.softmax(100.0 * similarities(x), dim=-1)
            probs = probs.cpu().numpy()
            top = int(probs.argmax())
            rec = {"filename": os.path.basename(path),
                   "prediction": classes[top],
                   "probs": {c: round(float(p), 6)
                             for c, p in zip(classes, probs)}}
            if args.saliency:
                x.requires_grad_(True)
                with torch.enable_grad():
                    (grad,) = torch.autograd.grad(similarities(x)[top], x)
                sal = grad.abs()[0].amax(dim=-1).cpu().numpy()
                sal_path = path + ".saliency.npy"
                np.save(sal_path, sal)
                rec["saliency"] = sal_path
            f.write(json.dumps(rec) + "\n")
            print(rec["filename"], "->", rec["prediction"])
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
