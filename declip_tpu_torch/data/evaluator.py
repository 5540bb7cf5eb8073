"""Evaluators: top-k accuracy over merged per-rank result dumps (the
port's copy of declip_tpu/data/evaluator.py; numpy only).

Rebuilds prototype/data/metrics/imagenet_evaluator.py (top-k from 'score' vs
'label' of merged JSONL result lines) plus the per-class CustomEvaluator.
"""

from __future__ import annotations

import glob
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from declip_tpu_torch.utils.registry import EVALUATORS


class Metric(dict):
    """Result mapping with a comparable headline metric
    (base_evaluator.py:7-17)."""

    def __init__(self, data: Dict, cmp_key: str = "top1"):
        super().__init__(data)
        self.metric = self
        self.cmp_key = cmp_key

    @property
    def headline(self) -> float:
        return float(self.get(self.cmp_key, 0.0))


@EVALUATORS.register(name="imagenet")
class ImageNetEvaluator:
    def __init__(self, topk: Sequence[int] = (1, 5)):
        self.topk = tuple(topk)

    def eval_arrays(self, scores: np.ndarray, labels: np.ndarray) -> Metric:
        order = np.argsort(-scores, axis=-1)
        res = {}
        for k in self.topk:
            hit = (order[:, :k] == labels[:, None]).any(axis=-1)
            res[f"top{k}"] = float(100.0 * hit.mean())
        res["n"] = int(labels.shape[0])
        return Metric(res)

    def eval_jsonl(self, path_or_lines) -> Metric:
        """Merged JSONL result lines with 'score' and 'label' per sample
        (imagenet_evaluator.py:24-62)."""
        if isinstance(path_or_lines, str):
            with open(path_or_lines) as f:
                lines = [json.loads(l) for l in f if l.strip()]
        else:
            lines = [json.loads(l) if isinstance(l, str) else l
                     for l in path_or_lines]
        scores = np.asarray([l["score"] for l in lines], np.float32)
        labels = np.asarray([l["label"] for l in lines], np.int64)
        return self.eval_arrays(scores, labels)


def merge_rank_results(prefix: str) -> List[dict]:
    """Concatenate results.txt.rank* shards (base_dataset.py:122-139)."""
    out: List[dict] = []
    for path in sorted(glob.glob(prefix + ".rank*")):
        with open(path) as f:
            out.extend(json.loads(l) for l in f if l.strip())
    return out


@EVALUATORS.register(name="custom")
class CustomEvaluator:
    """Per-class precision/recall/F1 (metrics/custom_evaluator.py)."""

    def __init__(self, num_classes: Optional[int] = None):
        self.num_classes = num_classes

    def eval_arrays(self, scores: np.ndarray, labels: np.ndarray) -> Metric:
        pred = scores.argmax(-1)
        n_cls = self.num_classes or int(scores.shape[-1])
        per_class = {}
        f1s = []
        for c in range(n_cls):
            tp = float(((pred == c) & (labels == c)).sum())
            fp = float(((pred == c) & (labels != c)).sum())
            fn = float(((pred != c) & (labels == c)).sum())
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            per_class[c] = {"precision": prec, "recall": rec, "f1": f1}
            f1s.append(f1)
        return Metric({
            "top1": float(100.0 * (pred == labels).mean()),
            "macro_f1": float(np.mean(f1s)) if f1s else 0.0,
            "per_class": per_class,
        })


@EVALUATORS.register(name="multicls")
class MultiClsEvaluator:
    """Multi-head classification accuracy (metrics/multicls_evaluator.py):
    scores is a list/array of per-head logits, labels [N, H]; reports per-head
    top-1 and the mean."""

    def __init__(self, num_heads: Optional[int] = None):
        self.num_heads = num_heads

    def eval_arrays(self, scores, labels: np.ndarray) -> Metric:
        labels = np.asarray(labels)
        if labels.ndim == 1:
            labels = labels[:, None]
        heads = self.num_heads or labels.shape[1]
        out = {}
        accs = []
        for h in range(heads):
            s = np.asarray(scores[h] if isinstance(scores, (list, tuple))
                           else scores)
            acc = float(100.0 * (s.argmax(-1) == labels[:, h]).mean())
            out[f"head{h}_top1"] = acc
            accs.append(acc)
        out["top1"] = float(np.mean(accs))
        return Metric(out)


def build_evaluator(cfg) -> object:
    return EVALUATORS.build(cfg)


@EVALUATORS.register(name="retrieval")
class RetrievalEvaluator:
    """Image<->text retrieval R@K + rank statistics.

    Beyond-reference (the reference evaluates classification only,
    prototype/data/metrics/): the standard CLIP-paper retrieval protocol —
    each image's paired caption is the single positive; reports
    i2t/t2i R@{1,5,10}, mean and median rank. The similarity matrix is
    processed in row chunks so a 50k-sample val set never materializes the
    full [N, N] (fp32 ~10GB).

    Ties rank conservatively (rank = 1 + #strictly-greater), so degenerate
    constant embeddings score ~0, not 100.
    """

    def __init__(self, topk: Sequence[int] = (1, 5, 10),
                 chunk: int = 1024):
        self.topk = tuple(topk)
        self.chunk = int(chunk)

    def _ranks(self, q: np.ndarray, g: np.ndarray) -> np.ndarray:
        """rank[i] of gallery item i for query i (1-based)."""
        n = q.shape[0]
        ranks = np.empty((n,), np.int64)
        for beg in range(0, n, self.chunk):
            end = min(beg + self.chunk, n)
            sim = q[beg:end] @ g.T  # [chunk, N]
            true = sim[np.arange(end - beg), np.arange(beg, end)]
            ranks[beg:end] = 1 + (sim > true[:, None]).sum(axis=-1)
        return ranks

    def eval_arrays(self, img_emb: np.ndarray, txt_emb: np.ndarray) -> Metric:
        img = np.asarray(img_emb, np.float32)
        txt = np.asarray(txt_emb, np.float32)
        img = img / np.maximum(
            np.linalg.norm(img, axis=-1, keepdims=True), 1e-12)
        txt = txt / np.maximum(
            np.linalg.norm(txt, axis=-1, keepdims=True), 1e-12)
        res: Dict = {"n": int(img.shape[0])}
        for name, ranks in (("i2t", self._ranks(img, txt)),
                            ("t2i", self._ranks(txt, img))):
            for k in self.topk:
                res[f"{name}_r{k}"] = float(100.0 * (ranks <= k).mean())
            res[f"{name}_mean_rank"] = float(ranks.mean())
            res[f"{name}_median_rank"] = float(np.median(ranks))
        return Metric(res, cmp_key="i2t_r1")
