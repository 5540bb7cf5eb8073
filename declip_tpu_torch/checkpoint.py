"""Checkpoint save/restore (port of declip_tpu/checkpoint.py:94-290, local
filesystem only).

Rebuilds the reference's single-file torch.save checkpointing
(declip_solver.py:796-815: ``{model, optimizer, last_iter[, ema]}`` written
by rank 0 every save_freq, long-horizon copies every 20x into
checkpoints_k_times/, auto-resume from the newest file,
clip_solver.py:128-176).

Format: the reference's ``ckpt.pth.tar`` / ``ckpt_<iter>.pth.tar``, a
``torch.save`` of

- ``model``: the model's state dict under the reference's names, BatchNorm
  running statistics included (what ``declip_tpu.convert_pth.load_pth`` and
  ``declip_tpu.tools.convert --to_pth`` read and write);
- ``last_iter``: the step;
- ``optimizer``: the rule's counts and each of its state slots by name
  (``OptState``: Adam's ``mu`` and ``nu``, SGD's ``trace``, Adafactor's
  ``v_row``/``v_col``/``v``, ...), ``{"count", "sched_count", slot:
  {key: tensor}, ...}``, which for Adam is the layout of the port's
  earlier checkpoints;
- ``ema``: the EMA shadow, or None;
- ``logit_guard``: the EMA_logit_scale guard's buffers, or None;
- ``bank``: DeCLIP's NN text bank and its pointer, or None;
- ``ssl``: MoCo's and CLSA's key encoder (its parameters and BatchNorm
  statistics, as a state dict), the queue and its pointer, or None;

beside a ``ckpt_meta.json`` sidecar with the saving run's topology. Under
FSDP or expert parallelism each save gathers the shards whole and each
restore cuts this rank's parts, so the file is the same at any world.
Writes
go to a temporary file and are renamed into place, so a reader never sees a
partial file. In a data-parallel run rank 0 writes, every rank restores the
same file, and ``broadcast_state`` gives every rank rank 0's state at the
start. ``gs://`` storage and the orbax backend of the JAX package
are not ported (orbax is TPU/pod-only).
"""

from __future__ import annotations

import glob
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from declip_tpu_torch.models.layers import discard_bn_stats

CKPT_RE = re.compile(r"ckpt_(\d+)\.pth\.tar$")


def _write_bytes(path: str, write) -> None:
    """``write(file)`` into ``path`` through a temporary file and a rename."""
    with open(path + ".tmp", "wb") as f:
        write(f)
    os.replace(path + ".tmp", path)


def _ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


# single-worker writer so async saves serialize + land in submission order
_writer: Optional[ThreadPoolExecutor] = None
_pending: list = []


def _get_writer() -> ThreadPoolExecutor:
    global _writer
    if _writer is None:
        _writer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
    return _writer


def wait_for_pending_saves() -> None:
    """Block until every async save has hit disk (call before reading a
    just-written checkpoint, at rollback, and at train end)."""
    global _pending
    for f in _pending:
        f.result()
    _pending = []


def _host_copy(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A CPU copy that owns its memory: ``.cpu()`` of a CPU tensor would
    alias the live tensor, which the next step updates in place."""
    return None if t is None else t.detach().to("cpu", copy=True)


def _whole(plan, slot: Optional[str] = None):
    """``(name, tensor) -> the whole tensor``: the gather of a shard of
    ``plan`` (a parameter-keyed slot's, or the EMA's), else the tensor."""
    from declip_tpu_torch.parallel.fsdp import LEAF_SLOTS

    if not plan or slot in LEAF_SLOTS:
        return lambda name, t: t
    return plan.full


def state_to_host(state) -> Dict:
    """The checkpoint dict of a ``TrainState``, every tensor copied to the
    host now, so that a writer thread may serialise it while training
    goes on. Under FSDP or expert parallelism (``state.shards``) the
    shards are gathered whole, the world-1 format, so every rank of the
    run calls it."""
    opt = state.opt_state
    bank = state.bank_text
    plan = getattr(state, "shards", None)
    whole = _whole(plan)
    guard = None
    if state.logit_ema_buffer is not None:
        guard = {"ema_buffer": _host_copy(state.logit_ema_buffer),
                 "clip_count": _host_copy(state.logit_clip_count)}
    return {
        "model": {k: _host_copy(whole(k, v))
                  for k, v in state.model.state_dict().items()},
        "last_iter": int(state.step),
        "optimizer": None if opt is None else {
            "count": int(opt.count),
            "sched_count": int(opt.sched_count),
            **{slot: {k: _host_copy(_whole(plan, slot)(k, v))
                      for k, v in tensors.items()}
               for slot, tensors in opt.slots.items()}},
        "ema": None if state.ema_params is None else {
            k: _host_copy(whole(k, v)) for k, v in state.ema_params.items()},
        "logit_guard": guard,
        "bank": None if bank is None else {"bank": _host_copy(bank.bank),
                                           "ptr": int(bank.ptr)},
        "ssl": None if state.ssl is None else {
            "key_model": {k: _host_copy(v) for k, v in
                          state.ssl.key_model.state_dict().items()},
            "queue": _host_copy(state.ssl.queue),
            "queue_ptr": int(state.ssl.queue_ptr)},
    }


def _write_state(host: Dict, step: int, path: str, ckpt_dir: str,
                 k_times_dir: Optional[str], meta: Optional[dict]) -> str:
    _write_bytes(path, lambda f: torch.save(host, f))
    _write_bytes(os.path.join(ckpt_dir, "ckpt_meta.json"),
                 lambda f: f.write(json.dumps(
                     {"last_iter": step, "path": path,
                      **(meta or {})}).encode()))
    if k_times_dir is not None:
        _ensure_dir(k_times_dir)
        _write_bytes(os.path.join(k_times_dir, os.path.basename(path)),
                     lambda f: torch.save(host, f))
    return path


def load_checkpoint_meta(ckpt_dir: str) -> dict:
    """The ckpt_meta.json sidecar ({} when absent/unreadable). Carries the
    saving run's topology (world_size/host_batch/global_batch)."""
    try:
        with open(os.path.join(ckpt_dir, "ckpt_meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):  # older/foreign ckpt dirs have no meta
        return {}


def save_checkpoint(ckpt_dir: str, state, *, save_many: bool = False,
                    k_times_dir: Optional[str] = None,
                    async_write: bool = False,
                    meta: Optional[dict] = None, write: bool = True) -> str:
    """Host-side save. Returns the written path.

    ``async_write=True`` overlaps the serialisation and the file write with
    training on a single writer thread; the copy to the host happens here,
    synchronously, so the step's in-place updates cannot reach what the
    writer holds. A sharded state (``state.shards``) is gathered by every
    rank: each calls this, and only the one with ``write`` writes."""
    step = int(state.step)
    host = state_to_host(state)
    name = f"ckpt_{step}.pth.tar" if save_many else "ckpt.pth.tar"
    path = os.path.join(ckpt_dir, name)
    if not write:
        return path
    _ensure_dir(ckpt_dir)
    if async_write:
        _pending.append(_get_writer().submit(
            _write_state, host, step, path, ckpt_dir, k_times_dir, meta))
        return path
    return _write_state(host, step, path, ckpt_dir, k_times_dir, meta)


def find_last_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The NEWEST checkpoint among ckpt.pth.tar and ckpt_<iter>.pth.tar,
    chosen by mtime with the step as tiebreak, so a stale plain file never
    shadows newer step-named saves (clip_solver.py:167-176)."""
    candidates = []
    plain = os.path.join(ckpt_dir, "ckpt.pth.tar")
    if os.path.exists(plain):
        candidates.append((os.path.getmtime(plain), 0, plain))
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.pth.tar")):
        m = CKPT_RE.search(p)
        if m:
            candidates.append((os.path.getmtime(p), int(m.group(1)), p))
    if not candidates:
        return None
    return max(candidates)[2]


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(step, path) of the ckpt_<iter>.pth.tar files, ascending."""
    out = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.pth.tar")):
        m = CKPT_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def gc_checkpoints(ckpt_dir: str, keep: int = 10) -> None:
    """Old-ckpt GC (declip_solver.py:570-576)."""
    for _, p in list_checkpoints(ckpt_dir)[:-keep]:
        try:
            os.remove(p)
        except OSError:
            pass


def _into(dst: torch.Tensor, src: torch.Tensor) -> None:
    with torch.no_grad():
        dst.copy_(src.to(dst.device, dst.dtype))


def restore_checkpoint(path: str, state):
    """Restore a checkpoint into ``state`` in place (the model's weights
    and buffers, the optimizer state, EMA, guard and bank keep their
    devices and dtypes) and return it. A sharded state takes this
    rank's part of each whole tensor.

    A file without optimizer state, such as the model-only file that
    ``declip_tpu.tools.convert --to_pth`` writes, raises: resuming it would
    restart Adam's moments and the schedule without a word. Start from it
    with ``saver.pretrain.path`` instead."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("optimizer") is None:
        raise ValueError(
            f"{path} holds no optimizer state (a model-only checkpoint, as "
            f"'declip_tpu.tools.convert --to_pth' writes); it cannot be "
            f"resumed. Start from its weights with saver.pretrain.path: "
            f"{path} (and move it out of the checkpoints directory)")
    plan = getattr(state, "shards", None)
    local = plan.local if plan else (lambda name, t: t)
    state.model.load_state_dict(
        {k: local(k, v) for k, v in ckpt["model"].items()}, strict=True)
    discard_bn_stats(state.model)
    opt = ckpt["optimizer"]
    st = state.opt_state
    saved = {k for k, v in opt.items() if isinstance(v, dict)}
    if saved != set(st.slots) or any(set(opt[slot]) != set(tensors)
                                     for slot, tensors in st.slots.items()):
        raise ValueError(
            f"{path}: optimizer state slots {sorted(saved)} differ from "
            f"this run's rule ({sorted(st.slots)}) or its names from the "
            f"model's parameters")
    from declip_tpu_torch.parallel.fsdp import LEAF_SLOTS

    for slot, tensors in st.slots.items():
        for n, t in tensors.items():
            src = opt[slot][n]
            _into(t, src if slot in LEAF_SLOTS else local(n, src))
    st.count = int(opt["count"])
    st.sched_count = int(opt.get("sched_count", opt["count"]))
    if state.ema_params is not None:
        if ckpt.get("ema") is None:
            raise ValueError(f"{path} holds no EMA, which this run keeps")
        for n, t in state.ema_params.items():
            _into(t, local(n, ckpt["ema"][n]))
    if state.logit_ema_buffer is not None:
        guard = ckpt.get("logit_guard")
        if guard is None:
            raise ValueError(f"{path} holds no logit-scale guard buffers, "
                             f"which this run keeps")
        _into(state.logit_ema_buffer, guard["ema_buffer"])
        _into(state.logit_clip_count, guard["clip_count"])
    if state.bank_text is not None:
        bank = ckpt.get("bank")
        if bank is None:
            raise ValueError(f"{path} holds no NN bank, which this run keeps")
        _into(state.bank_text.bank, bank["bank"])
        state.bank_text.ptr = int(bank["ptr"])
    if state.ssl is not None:
        ssl = ckpt.get("ssl")
        if ssl is None:
            raise ValueError(f"{path} holds no key encoder and queue, which "
                             f"this run keeps")
        state.ssl.key_model.load_state_dict(ssl["key_model"], strict=True)
        discard_bn_stats(state.ssl.key_model)
        _into(state.ssl.queue, ssl["queue"])
        state.ssl.queue_ptr = int(ssl["queue_ptr"])
    state.step = int(ckpt["last_iter"])
    return state


@torch.no_grad()
def broadcast_state(state, group):
    """Rank 0's model parameters and buffers (BatchNorm statistics), NN
    bank and SSL state (the key encoder's parameters and buffers, the
    queue and its pointer) on every rank of ``group``, in place: the ranks
    of a data-parallel run start from the same state. Nothing without a
    group."""
    if group is None:
        return state
    from declip_tpu_torch.parallel import comms

    for t in list(state.model.parameters()) + list(state.model.buffers()):
        comms.broadcast_(t.data, group)
    if state.bank_text is not None:
        comms.broadcast_(state.bank_text.bank, group)
        state.bank_text.ptr = comms.broadcast_object(
            state.bank_text.ptr, 0, group)
    if state.ssl is not None:
        key = state.ssl.key_model
        for t in [*key.parameters(), *key.buffers(), state.ssl.queue]:
            comms.broadcast_(t.data, group)
        state.ssl.queue_ptr = comms.broadcast_object(
            state.ssl.queue_ptr, 0, group)
    return state


def _ignored(key: str, ignore: Sequence[str]) -> bool:
    # component-boundary match: "encode_text" ignores encode_text.* but not
    # a sibling whose name merely starts with it
    return any(key == ig or key.startswith(ig + ".") for ig in ignore)


def load_pretrain(path: str, state, ignore: Sequence[str] = ()):
    """Load MODEL weights only (parameters and BatchNorm statistics) from a
    ``.pth(.tar)`` into ``state``'s model, keeping its optimizer state,
    step and EMA (the reference's pretrain flow: ``modify_state`` drops
    optimizer/ema/last_iter, then a strict=False load,
    clip_solver.py:140-163, misc.py:441-479).

    ``ignore``: state-dict name prefixes (``encode_text``,
    ``text_label_predictor``) kept at their initialisation. A weight that is absent from the file or
    has another shape is kept too and listed. Returns ``(state,
    unmatched)``. A JAX msgpack checkpoint raises: convert it with
    ``python -m declip_tpu.tools.convert --to_pth`` first."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path} is a JAX msgpack checkpoint, which the port does not "
            f"read; convert it with 'python -m declip_tpu.tools.convert "
            f"--config <config> --to_pth {path} --out <file>.pth.tar'")
    from declip_tpu_torch.convert import load_pth

    raw = load_pth(path)
    ignore = tuple(ignore)
    unmatched: List[str] = []
    own = state.model.state_dict()
    for key, dst in own.items():
        if _ignored(key, ignore):
            continue
        src = raw.get(key)
        if src is None or tuple(src.shape) != tuple(dst.shape):
            unmatched.append(key)
            continue
        _into(dst, src)
    return state, unmatched
