"""Text-embedding visualization tool (port of
declip_tpu/tools/text_visualize.py).

Rebuilds prototype/tools/text_visualize.py: embed a list of texts with a
trained checkpoint and write a 2-D projection (PCA, dependency-free) and
the pairwise cosine-similarity matrix for inspection, then print each
text's nearest other text.

    python -m declip_tpu_torch.tools.text_visualize --config <exp>/config.yaml \
        --texts "a cat,a dog,a car" [--out text_viz.json] [--device cuda|cpu]

The JSON has the JAX tool's keys, ``texts``, ``pca_2d`` and
``cosine_similarity``, each number rounded to 5 places. The text tower
loads through ``load_eval_model`` (the newest ``checkpoints/ckpt*.pth.tar``,
float32) and runs on the card unless ``--device`` asks for the CPU; there
its attention is K1, causal at L = 77.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from declip_tpu_torch.tokenizer import get_tokenizer
from declip_tpu_torch.tools._common import load_eval_model


def pca_2d(x: np.ndarray) -> np.ndarray:
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def embed_texts(model, texts: List[str]) -> np.ndarray:
    """``[N, D]`` unit text embeddings, float32, on the host."""
    device = next(model.parameters()).device
    tokens = torch.from_numpy(np.asarray(get_tokenizer().tokenize(texts),
                                         np.int64)).to(device)
    with torch.no_grad():
        emb = model.encode_text(tokens).float()
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb.cpu().numpy()


def main(argv: Optional[List[str]] = None) -> dict:
    """The CLI -> the JSON object written to ``--out``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--texts", required=True, help="comma-separated texts")
    ap.add_argument("--out", default="text_viz.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)

    model = load_eval_model(args.config, args.device)
    texts = [t.strip() for t in args.texts.split(",")]
    emb = embed_texts(model, texts)

    coords = pca_2d(emb)
    sim = emb @ emb.T
    result = {
        "texts": texts,
        "pca_2d": coords.round(5).tolist(),
        "cosine_similarity": sim.round(5).tolist(),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    for i, t in enumerate(texts):
        nearest = int(np.argsort(-sim[i])[1]) if len(texts) > 1 else i
        print(f"  {t!r} -> nearest: {texts[nearest]!r} "
              f"({sim[i, nearest]:.3f})")
    return result


if __name__ == "__main__":
    main()
