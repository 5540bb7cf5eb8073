"""The learnability run's host batches (numpy only): the training pool,
the batch of ``experiments/learnability_tpu.py``'s ``make_batch`` as
arrays, and a stream of them built ahead in a worker process.

``tools/learnability.py`` trains on these. Rendering 256 colored shapes and
tokenising 256 captions a batch takes the host about as long as the tiny
DeCLIP step itself, so the run draws its batches from :func:`batch_stream`:
one spawned process owns the generator and builds the batches in order,
the same batches as calling :func:`batch_arrays` in a loop, while the
training process runs its steps. The module imports no torch, so the
worker starts in a fraction of a second and never touches the card.
"""

from __future__ import annotations

import multiprocessing
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from declip_tpu_torch.data.synthetic_shapes import (
    CLASSES,
    captions,
    render,
    render_class_batch,
)
from declip_tpu_torch.tokenizer import get_tokenizer
from declip_tpu_torch.tokenizer.mlm import mask_tokens

RES = 32


class Pool:
    """Fixed training pool: the limited-data regime. Second views pair each
    sample with ANOTHER pool member of the same class (DeCLIP's aug view),
    falling back to itself when the class has a single member."""

    def __init__(self, rng, size, res):
        self.imgs, self.idx = render_class_batch(rng, size, res=res)
        self.by_class = {c: np.flatnonzero(self.idx == c)
                         for c in range(len(CLASSES))}

    def sample(self, rng, n):
        sel = rng.integers(0, len(self.idx), n)
        idx = self.idx[sel]
        alt = np.array([
            rng.choice(self.by_class[c]) if len(self.by_class[c]) > 1 else s
            for s, c in zip(sel, idx)])
        return self.imgs[sel], self.imgs[alt], idx


def batch_arrays(rng, tok, n, pool=None, recipe="declip"):
    """DeCLIP batch: two views stacked on the channels ``[n, R, R, 6]``,
    two caption streams, MLM-masked main tokens (dataloader.py:95-122
    layout); ``recipe="clip"`` keeps one view and plain tokens. -> (the
    batch as numpy arrays, the class indices)."""
    if pool is not None:
        imgs, imgs2, idx = pool.sample(rng, n)
    else:
        imgs, idx = render_class_batch(rng, n, res=RES)
        # view 2: an independent rendering of the SAME class, a harder
        # positive than a photometric augmentation of one image
        imgs2 = np.stack([render(rng, *CLASSES[i], res=RES) for i in idx])
    if recipe == "clip":
        return {"images": imgs, "tokens": tok.tokenize(captions(idx))}, idx
    tokens = tok.tokenize(captions(idx))
    tokens_aug = tok.tokenize(captions(idx, template="a photo of a {} {}"))
    mlm_tokens, mlm_labels = mask_tokens(
        tokens, mask_id=tok.mask_id, vocab_size=tok.vocab_size,
        special_ids=(tok.sot_id, tok.eot_id, tok.mask_id), rng=rng)
    return {"images": np.concatenate([imgs, imgs2], axis=-1),
            "tokens": tokens, "tokens_aug": tokens_aug,
            "mlm_tokens": mlm_tokens,
            "mlm_labels": mlm_labels.astype(np.int32)}, idx


_WORKER: dict = {}  # the stream worker's generator, tokenizer and shape


def _worker_init(rng, n, pool, recipe):
    _WORKER.update(rng=rng, tok=get_tokenizer(None), n=n, pool=pool,
                   recipe=recipe)


def _worker_batch() -> Dict[str, np.ndarray]:
    w = _WORKER
    return batch_arrays(w["rng"], w["tok"], w["n"], w["pool"],
                        w["recipe"])[0]


def batch_stream(rng, n: int, steps: int, pool: Optional[Pool] = None,
                 recipe: str = "declip",
                 ahead: int = 4) -> Iterator[Dict[str, np.ndarray]]:
    """The next ``steps`` batches of :func:`batch_arrays` on a copy of
    ``rng`` (the caller's generator does not move), tokenised with the
    hermetic byte-level vocabulary (``get_tokenizer(None)``), built by one
    spawned worker process up to ``ahead`` batches in front of the one
    taken. The worker is shut down when the stream ends or is closed."""
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
            initargs=(rng, n, pool, recipe)) as workers:
        # one worker runs the calls in the order they were submitted
        inflight = deque(workers.submit(_worker_batch)
                         for _ in range(min(ahead, steps)))
        try:
            for i in range(steps):
                arrays = inflight.popleft().result()
                if i + ahead < steps:
                    inflight.append(workers.submit(_worker_batch))
                yield arrays
        finally:
            for f in inflight:
                f.cancel()
