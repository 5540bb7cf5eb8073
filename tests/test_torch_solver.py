"""The port's solver (declip_tpu_torch.solver) on the CPU.

Against the JAX package's Solver: tiny_clip in fp32 under ONECROP training
crops, both solvers starting from one ``.pth.tar`` through
``saver.pretrain.path`` and training on one device with one global batch:
per-step losses within rtol 1e-4, per-image zero-shot scores within atol
1e-4 and equal top-1/top-5; the port's checkpoint loads through the JAX
package's ``load_pretrain`` with no unmatched key.

Against the JAX package's Solver too, the FILIP family's dense zero-shot
eval: tiny_filip from one ``.pth.tar``, its default (dense) eval over 20
synthetic images in batches of 16 (the tail batch padded): per-image
scores within atol 1e-4, equal top-1/top-5, and the dense class
embeddings against JAX's ``_dense_class_embeddings`` within rtol 1e-4.

Port-only: resume equivalence bit for bit (8 steps straight against 4, a
SIGTERM, and 4 auto-resumed), rollback on a planted NaN (three saves back,
warmup_lr x 0.997, ``rollback_reset_opt`` through ``fast_forward_schedule``),
tiny_declip end to end through ``main`` (MOCOV2, EDA, MLM, the bank) with
the bank restored on resume, tiny_defilip (dense eval) and tiny_slip
(SLIP's three views) end to end through ``main``, every reference config of
the FILIP family and SLIP built at full width on the meta device and into a
Solver on the CPU with its towers cut to one narrow layer, an async save
that holds a copy, and the refusals: a JAX-only or model-only checkpoint directory, a checkpoint of
another topology, an absent CUDA, and the parts not ported yet.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CLIP = os.path.join(REPO, "experiments", "unit", "tiny_clip",
                         "config.yaml")
TINY_DECLIP = os.path.join(REPO, "experiments", "unit", "tiny_declip",
                           "config.yaml")
TINY_FILIP, TINY_DEFILIP, TINY_SLIP = (
    os.path.join(REPO, "experiments", "unit", name, "config.yaml")
    for name in ("tiny_filip", "tiny_defilip", "tiny_slip"))
STEPS = 4
# a 16-image zero-shot set (synthetic, 10 classes, ONECROP, prompt8)
TEST16 = [{"type": "clip", "read_from": "synthetic", "meta_file": "16",
           "batch_size": 16, "transforms": {"type": "ONECROP"},
           "label_texts_ensemble": "prompt8"}]


def _cfg(pkg, exp_dir, src, sets):
    """``src`` copied into ``exp_dir`` and parsed by ``pkg``'s config
    module with the ``sets`` overrides (what --set does)."""
    import importlib

    config = importlib.import_module(f"{pkg}.config")
    exp_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, exp_dir / "config.yaml")
    cfg = config.parse_config(str(exp_dir / "config.yaml"))
    for key, value in sets.items():
        cfg = config.override(cfg, key, value)
    cfg["_config_path"] = str(exp_dir / "config.yaml")
    return cfg


def _scalars(exp_dir, tag):
    lines = (exp_dir / "events" / "scalars.jsonl").read_text().splitlines()
    return [(r["step"], r["value"]) for r in map(json.loads, lines)
            if r["tag"] == tag]


def _results(exp_dir):
    lines = (exp_dir / "results" / "results.txt.rank0").read_text()
    return [json.loads(line) for line in lines.splitlines()]


CLIP_SETS = {"lr_scheduler.kwargs.max_iter": STEPS,
             "saver.print_freq": 1, "saver.save_freq": 2,
             "data.train.transforms": {"type": "ONECROP"}}


@pytest.fixture(scope="module")
def pair_run(tmp_path_factory):
    """tiny_clip trained 4 steps by both solvers from one seeded
    ``.pth.tar``; the JAX solver on one CPU device."""
    import jax

    from declip_tpu.solver import Solver as JaxSolver
    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.solver import Solver

    root = tmp_path_factory.mktemp("pair")
    cfg = parse_config(TINY_CLIP)
    model = model_entry({"type": cfg.model.type,
                         "kwargs": {**cfg.model.kwargs, "dtype": "float32"}})
    model.init_weights(torch.Generator().manual_seed(3))
    pretrain = root / "init.pth.tar"
    torch.save({"model": model.state_dict()}, pretrain)
    sets = {**CLIP_SETS, "saver.pretrain.path": str(pretrain),
            "data.test": [dict(cfg.data.test[0], meta_file="32")],
            "check_grad": True}

    jax_solver = JaxSolver(_cfg("declip_tpu", root / "jax", TINY_CLIP, sets),
                           devices=jax.devices()[:1])
    jax_solver.train()
    port = Solver(_cfg("declip_tpu_torch", root / "port", TINY_CLIP, sets),
                  device="cpu")
    port.train()
    return {"jax": root / "jax", "port": root / "port",
            "jax_solver": jax_solver, "port_solver": port}


def test_losses_match_jax(pair_run):
    want = _scalars(pair_run["jax"], "loss")
    got = _scalars(pair_run["port"], "loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    # the step moved the weights: the losses are not all one value
    assert len({round(v, 6) for _, v in got}) > 1
    for tag in ("lr", "top1"):
        np.testing.assert_allclose(
            [v for _, v in _scalars(pair_run["port"], tag)],
            [v for _, v in _scalars(pair_run["jax"], tag)], rtol=1e-5)


def test_check_grad_matches_jax(pair_run):
    """``check_grad``: the per-top-module gradient norms under the JAX
    package's tags (``grad_norm/text``, not the port's ``encode_text``),
    step by step: step 1, from the same weights, within rtol 1e-5; later
    steps within the trajectory's 1e-4 (test_losses_match_jax), since the
    weights have moved apart by then."""
    def norms(run):
        lines = (run / "events" / "scalars.jsonl").read_text().splitlines()
        out = {}
        for r in map(json.loads, lines):
            if r["tag"].startswith("grad_norm/"):
                out.setdefault(r["tag"], []).append((r["step"], r["value"]))
        return out

    want, got = norms(pair_run["jax"]), norms(pair_run["port"])
    assert set(got) == set(want) == {"grad_norm/visual", "grad_norm/text",
                                     "grad_norm/logit_scale"}
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == \
            [1, 2, 3, 4]
        np.testing.assert_allclose(got[tag][0][1], want[tag][0][1],
                                   rtol=1e-5, err_msg=tag)
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in want[tag]], rtol=1e-4,
                                   err_msg=tag)


def test_zero_shot_scores_match_jax(pair_run):
    want, got = _results(pair_run["jax"]), _results(pair_run["port"])
    assert len(got) == len(want) == 32
    for g, w in zip(got, want):
        assert (g["image_id"], g["label"], g["label_name"]) == \
            (w["image_id"], w["label"], w["label_name"])
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-4)
    for tag in ("eval0/top1", "eval0/top5"):
        assert _scalars(pair_run["port"], tag) == \
            _scalars(pair_run["jax"], tag)


def test_checkpoint_loads_in_jax(pair_run):
    """The port's ckpt_<step>.pth.tar through the JAX package's
    load_pretrain: every weight matched, and equal to the port's."""
    from declip_tpu.checkpoint import load_pretrain as jax_load_pretrain
    from declip_tpu_torch.convert import state_from_jax_variables

    path = pair_run["port"] / "checkpoints" / f"ckpt_{STEPS}.pth.tar"
    state, unmatched = jax_load_pretrain(
        str(path), pair_run["jax_solver"].state)
    assert unmatched == []
    back = state_from_jax_variables({"params": jax.device_get(state.params)})
    own = pair_run["port_solver"].model.state_dict()
    assert set(back) == set(own)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), own[k].numpy(), err_msg=k)


def test_retrieval_eval_matches_jax(pair_run):
    """evaluate() with ``evaluation: {type: retrieval}`` on the trained
    weights: the same ranks, so the same R@K and mean/median ranks."""
    tcfg = {"read_from": "synthetic", "meta_file": "24", "batch_size": 16,
            "transforms": {"type": "ONECROP"},
            "evaluation": {"type": "retrieval", "kwargs": {"topk": [1, 5]}}}
    got = pair_run["port_solver"].evaluate(tcfg)
    want = pair_run["jax_solver"].evaluate(tcfg)
    assert set(got) == set(want) and got["n"] == 24
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def _declip_sets(**extra):
    return {"lr_scheduler.kwargs.max_iter": 8, "saver.print_freq": 1,
            "saver.save_freq": 2, "data.test": [], **extra}


def _two_view_onecrop(solver):
    """A deterministic two-view transform in place of MOCOV2, whose draws
    come from the module-global stream and so differ run to run."""
    from declip_tpu_torch.data.transforms import (
        MultiView,
        build_common_augmentation,
    )

    crop = build_common_augmentation("ONECROP")
    solver.train_dataset.transform = MultiView([crop, crop])


def _snapshot(solver):
    st = solver.state
    return {
        "model": {k: v.clone() for k, v in st.model.state_dict().items()},
        "mu": {k: v.clone() for k, v in st.opt_state.mu.items()},
        "nu": {k: v.clone() for k, v in st.opt_state.nu.items()},
        "counts": (st.opt_state.count, st.opt_state.sched_count, st.step),
        "ema": {k: v.clone() for k, v in st.ema_params.items()},
        "guard": (st.logit_ema_buffer.clone(), st.logit_clip_count.clone()),
        "bank": (st.bank_text.bank.clone(), st.bank_text.ptr),
    }


def _assert_same(a, b):
    assert a["counts"] == b["counts"]
    assert a["bank"][1] == b["bank"][1]
    assert torch.equal(a["bank"][0], b["bank"][0])
    for x, y in zip(a["guard"], b["guard"]):
        assert torch.equal(x, y)
    for key in ("model", "mu", "nu", "ema"):
        assert set(a[key]) == set(b[key])
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)


def test_resume_is_bit_exact(tmp_path):
    """tiny_declip (MLM, EDA, the bank, EMA, the logit-scale guard): 8 steps
    straight against 4, a SIGTERM (the preemption guard's final save), and
    a fresh solver that auto-resumes at 4 and trains to 8."""
    import signal

    from declip_tpu_torch.solver import Solver

    straight = Solver(_cfg("declip_tpu_torch", tmp_path / "a", TINY_DECLIP,
                           _declip_sets()), device="cpu")
    _two_view_onecrop(straight)
    straight.train()

    first = Solver(_cfg("declip_tpu_torch", tmp_path / "b", TINY_DECLIP,
                        _declip_sets()), device="cpu")
    _two_view_onecrop(first)
    step = first._train_step

    def step_then_signal(state, batch):
        out = step(state, batch)
        if state.step == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    first._train_step = step_then_signal
    first.train()
    assert first.state.step == 4
    meta = json.loads((tmp_path / "b" / "checkpoints" /
                       "ckpt_meta.json").read_text())
    assert meta["last_iter"] == 4 and meta["global_batch"] == 4
    second = Solver(_cfg("declip_tpu_torch", tmp_path / "b", TINY_DECLIP,
                         _declip_sets()), device="cpu")
    assert second.start_step == 4
    _two_view_onecrop(second)
    second.train()
    _assert_same(_snapshot(second), _snapshot(straight))
    losses = [v for s, v in _scalars(tmp_path / "b", "loss") if s > 4]
    np.testing.assert_array_equal(
        losses, [v for s, v in _scalars(tmp_path / "a", "loss") if s > 4])


def test_rollback_on_a_planted_nan(tmp_path):
    """A NaN in step 6's images: the step is skipped, the loss is NaN, and
    the solver rolls back three saves behind the newest (saves at 1..5:
    ckpt_2), warmup_lr x 0.997, a fresh optimizer whose schedule is
    fast-forwarded to step 2; then it trains on to the end."""
    from declip_tpu_torch.solver import Solver

    cfg = _cfg("declip_tpu_torch", tmp_path, TINY_CLIP, {
        **CLIP_SETS, "data.test": [], "saver.save_freq": 1,
        "saver.rollback": True, "saver.rollback_reset_opt": True,
        "saver.async_save": False, "lr_scheduler.kwargs.max_iter": 8})
    solver = Solver(cfg, device="cpu")
    step, rollback = solver._train_step, solver._rollback
    seen = {}

    def planted(state, batch):
        if state.step == 5 and "planted" not in seen:
            seen["planted"] = True
            batch = dict(batch, images=batch["images"].clone())
            batch["images"][0, 0, 0, 0] = float("nan")
        state, metrics = step(state, batch)
        seen.setdefault("skipped", []).append(metrics["update_skipped"])
        return state, metrics

    def checked_rollback(at):
        assert rollback(at)
        st = solver.state
        seen["at"] = (at, st.step, st.opt_state.count,
                      st.opt_state.sched_count)
        seen["mu_zero"] = all(not t.any() for t in st.opt_state.mu.values())
        ckpt = torch.load(tmp_path / "checkpoints" / "ckpt_2.pth.tar",
                          weights_only=True)
        for k, v in st.model.state_dict().items():
            assert torch.equal(v, ckpt["model"][k]), k
        return True

    solver._train_step = planted
    solver._rollback = checked_rollback
    solver.train()
    assert seen["skipped"] == [0.0] * 5 + [1.0]
    assert seen["at"] == (6, 2, 0, 2) and seen["mu_zero"]
    assert solver._warmup_decay == pytest.approx(0.997)
    warm = float(cfg.lr_scheduler.kwargs.warmup_lr) * 0.997
    ws = int(cfg.lr_scheduler.kwargs.warmup_steps)
    assert solver.schedule(ws - 1) == pytest.approx(warm, rel=1e-6)
    st = solver.state
    assert (st.step, st.opt_state.count, st.opt_state.sched_count) == \
        (8, 6, 8)
    assert np.isfinite([v for _, v in _scalars(tmp_path, "loss")][-1])


def test_tiny_declip_end_to_end_through_main(tmp_path):
    """``main`` on tiny_declip as configured (MOCOV2 views, EDA, MLM, the
    512-row bank, EMA), then a resume that restores the bank."""
    from declip_tpu_torch.solver import Solver, main

    cfg_path = tmp_path / "config.yaml"
    shutil.copy(TINY_DECLIP, cfg_path)
    solver = main(["--config", str(cfg_path), "--device", "cpu", "--set",
                   "lr_scheduler.kwargs.max_iter=4", "saver.save_freq=2",
                   "saver.print_freq=1", "data.test=" + json.dumps(TEST16)])
    st = solver.state
    assert solver.method == "declip" and solver.train_cfg["transforms"] == \
        {"type": "MOCOV2"}
    assert st.step == 4 and st.bank_text.ptr == (2 * 4 * 4) % 512
    for tag in ("loss", "clip_loss", "simsiam_loss", "text_mlm_loss",
                "clip_nn_text_loss"):
        values = [v for _, v in _scalars(tmp_path, tag)]
        assert len(values) == 4 and np.isfinite(values).all(), tag
    assert [v for _, v in _scalars(tmp_path, "update_skipped")] == [0.0] * 4
    assert sorted(os.listdir(tmp_path / "checkpoints")) == \
        ["ckpt_2.pth.tar", "ckpt_4.pth.tar", "ckpt_meta.json"]
    assert len(_results(tmp_path)) == 16
    tags = {t for t in map(lambda r: json.loads(r)["tag"], (
        tmp_path / "events" / "scalars.jsonl").read_text().splitlines())}
    assert {"eval0/top1", "eval0/ema_top1"} <= tags

    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt_4.pth.tar",
                      weights_only=True)
    from declip_tpu_torch.config import override, parse_config

    cfg = parse_config(str(cfg_path))
    cfg = override(cfg, "lr_scheduler.kwargs.max_iter", 6)
    resumed = Solver(cfg, device="cpu")
    assert resumed.start_step == 4
    assert resumed.state.bank_text.ptr == ckpt["bank"]["ptr"] == 32
    assert torch.equal(resumed.state.bank_text.bank, ckpt["bank"]["bank"])
    assert torch.equal(resumed.state.bank_text.bank, st.bank_text.bank)


def test_tiny_clip_siglip_through_main_resumes_bit_for_bit(tmp_path):
    """``main`` on tiny_clip with the SigLIP recipe's loss and optimizer
    set (``sigmoid_ring``, ``logit_bias_init`` -10, Adafactor, the norm
    clip): 2 steps with a save at 1 and 2, the bias logged; then a run
    resumed from step 1 ends at step 2 on the same parameters, Adafactor's
    slots and the bias bit for bit."""
    from declip_tpu_torch.solver import main

    sets = ["lr_scheduler.kwargs.max_iter=2", "saver.save_freq=1",
            "saver.print_freq=1", "data.test=[]",
            "loss_impl.type=sigmoid_ring",
            "model.kwargs.clip.logit_bias_init=-10.0",
            "grad_clip={\"type\": \"norm\", \"value\": 1.0}",
            "optimizer.type=Adafactor",
            "optimizer.kwargs={\"lr\": 0.001, \"weight_decay\": 0.0001}"]
    runs = []
    for name in ("whole", "resumed"):
        exp = tmp_path / name
        exp.mkdir()
        shutil.copy(TINY_CLIP, exp / "config.yaml")
        if name == "resumed":
            # the whole run's step-1 checkpoint, alone
            os.makedirs(exp / "checkpoints")
            shutil.copy(tmp_path / "whole" / "checkpoints" /
                        "ckpt_1.pth.tar", exp / "checkpoints")
        runs.append(main(["--config", str(exp / "config.yaml"), "--device",
                          "cpu", "--set", *sets]))
    whole, resumed = runs
    assert resumed.start_step == 1 and resumed.state.step == 2
    assert sorted(whole.state.opt_state.slots) == ["v", "v_col", "v_row"]
    bias = [v for _, v in _scalars(tmp_path / "whole", "logit_bias")]
    # the bias each step's forward read: the init twice, the first step's
    # lr being the schedule's base_lr 0; the second step moves it
    assert bias == [-10.0, -10.0]
    assert float(whole.state.params["logit_bias"][0]) != -10.0
    assert [v for _, v in _scalars(tmp_path / "whole", "update_skipped")] \
        == [0.0, 0.0]
    for n, p in whole.state.params.items():
        assert torch.equal(p, resumed.state.params[n]), n
    for slot, tensors in whole.state.opt_state.slots.items():
        for k, t in tensors.items():
            assert torch.equal(t, resumed.state.opt_state.slots[slot][k]), k


def test_main_evaluate_prints_the_metric(tmp_path, capsys):
    """``--evaluate`` runs data.test and prints the metrics as JSON."""
    from declip_tpu_torch.solver import main

    shutil.copy(TINY_CLIP, tmp_path / "config.yaml")
    solver = main(["--config", str(tmp_path / "config.yaml"), "--device",
                   "cpu", "--evaluate", "--set",
                   "data.test=" + json.dumps(TEST16)])
    assert solver.state.step == 0 and not (tmp_path / "checkpoints" /
                                           "ckpt_0.pth.tar").exists()
    out = capsys.readouterr().out
    metrics = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert metrics["n"] == 16 and 0 <= metrics["top1"] <= 100
    assert len(_results(tmp_path)) == 16


def test_eval_leaves_the_model_as_it_was(tmp_path):
    """validate() with EMA: eval mode and back, no pending BatchNorm
    statistics, and every weight and buffer bit for bit as before."""
    from declip_tpu_torch.models.layers import BatchNorm
    from declip_tpu_torch.solver import Solver

    solver = Solver(_cfg("declip_tpu_torch", tmp_path, TINY_DECLIP,
                         {"data.test": TEST16}), device="cpu")
    with torch.no_grad():
        for n, t in solver.state.ema_params.items():
            t.copy_(torch.randn_like(t))  # EMA weights unlike the model's
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    solver.model.train()
    solver.validate(0)
    assert solver.model.training
    assert all(m.pending is None for m in solver.model.modules()
               if isinstance(m, BatchNorm))
    for k, v in solver.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    solver.writer.flush()
    assert len(_scalars(tmp_path, "eval0/top1")) == 1
    assert len(_scalars(tmp_path, "eval0/ema_top1")) == 1


def test_async_save_holds_a_copy(tmp_path):
    """The writer thread serialises host copies taken at the call: an
    in-place update right after an async save does not reach the file (on
    the CPU, .cpu() would alias the live tensors)."""
    from declip_tpu_torch.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        wait_for_pending_saves,
    )
    from declip_tpu_torch.solver import Solver

    solver = Solver(_cfg("declip_tpu_torch", tmp_path, TINY_DECLIP,
                         {"data.test": []}), device="cpu")
    state = solver.state
    want = _snapshot(solver)
    save_checkpoint(str(tmp_path / "ck"), state, save_many=True,
                    async_write=True)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for t in state.opt_state.mu.values():
            t.add_(1.0)
        state.bank_text.bank.add_(1.0)
    wait_for_pending_saves()
    restore_checkpoint(str(tmp_path / "ck" / "ckpt_0.pth.tar"), state)
    _assert_same(_snapshot(solver), want)


def test_refuses_jax_and_model_only_checkpoints(tmp_path):
    from declip_tpu_torch.solver import Solver

    cfg = _cfg("declip_tpu_torch", tmp_path, TINY_CLIP, {"data.test": []})
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "ckpt_30.msgpack").write_bytes(b"")
    with pytest.raises(FileNotFoundError,
                       match="(?s)ckpt_30.msgpack.*declip_tpu.tools.convert "
                             "--config .* --to_pth"):
        Solver(cfg, device="cpu")
    model = Solver(_cfg("declip_tpu_torch", tmp_path / "other", TINY_CLIP,
                        {"data.test": []}), device="cpu").model
    torch.save({"model": model.state_dict(), "last_iter": 30},
               tmp_path / "checkpoints" / "ckpt.pth.tar")
    with pytest.raises(ValueError, match="(?s)no optimizer state.*"
                                         "saver.pretrain.path"):
        Solver(cfg, device="cpu")


def test_resume_refuses_another_topology(tmp_path):
    """A checkpoint resumes on another topology only where the global
    batch stays the same (the elastic resume, tests/test_torch_dist.py):
    another batch_size on the same world changes it and raises."""
    from declip_tpu_torch.solver import Solver

    sets = {"lr_scheduler.kwargs.max_iter": 1, "saver.save_freq": 1,
            "data.test": []}
    Solver(_cfg("declip_tpu_torch", tmp_path, TINY_CLIP, sets),
           device="cpu").train()
    meta = json.loads((tmp_path / "checkpoints" /
                       "ckpt_meta.json").read_text())
    assert (meta["world_size"], meta["last_iter"]) == (1, 1)
    other = meta["host_batch"] * 2
    with pytest.raises(ValueError, match=f"(?s)1 x batch "
                                         f"{meta['host_batch']} checkpoint "
                                         f"on 1 x {other} changes the "
                                         f"global batch"):
        Solver(_cfg("declip_tpu_torch", tmp_path, TINY_CLIP,
                    {**sets, "data.train.batch_size": other}), device="cpu")


def test_main_refuses_absent_cuda(tmp_path, monkeypatch):
    from declip_tpu_torch.solver import main

    shutil.copy(TINY_CLIP, tmp_path / "config.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", str(tmp_path / "config.yaml")])
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("sets,exc,match", [
    ({"parallelism": {"tp": 2}}, NotImplementedError, "item 1.10"),
    # the SSL builders train, and have no text tower for tiny_clip's
    # zero-shot eval (neither has the JAX package an SSL eval)
    ({"model.type": "moco_res50",
      "model.kwargs": {"image_encode": {"layers": [1, 1, 1, 1],
                                        "width": 8, "embed_dim": 32}}},
     ValueError, "needs a text tower"),
    # device_aug, wds shards and the native reader are ported; what stays
    # out beside them: shards on object stores and the reference's kestrel
    # hardware decoder; CLSA's views have no device_aug geometry, as in the
    # JAX package
    ({"data.train.device_aug": True,
      "data.train.transforms": {"type": "CLSA"}}, KeyError,
     "no geometry variant"),
    ({"data.train.type": "clip_wds",
      "data.train.tar_files": "gs://bucket/s-{0000..0003}.tar"},
     NotImplementedError, "item 1.7a.5"),
    ({"data.train.read_from": "gcs"}, NotImplementedError, "item 1.7a"),
    ({"data.train.image_reader": {"type": "kestrel"}}, NotImplementedError,
     "kestrel"),
], ids=["parallelism", "ssl", "device_aug", "wds", "gcs", "native"])
def test_unported_parts_raise(tmp_path, sets, exc, match):
    from declip_tpu_torch.solver import Solver

    cfg = _cfg("declip_tpu_torch", tmp_path, TINY_CLIP, sets)
    with pytest.raises(exc, match=match):
        Solver(cfg, device="cpu")


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_device_aug_ships_uint8_crops(tmp_path, worker_type):
    """``device_aug`` with either worker type: the step gets the loader's
    uint8 geometry crops (with process workers too, which rebuild the
    dataset: the reference's solver handed them fp32 MOCOV2 views), the
    losses are finite, and the step raises on fp32 images."""
    from declip_tpu_torch.solver import Solver

    solver = Solver(_cfg("declip_tpu_torch", tmp_path, TINY_DECLIP, {
        **_declip_sets(), "lr_scheduler.kwargs.max_iter": 2,
        "saver.save_freq": 0, "data.train.device_aug": True,
        "data.train.worker_type": worker_type,
        "data.train.num_workers": 1}), device="cpu")
    assert solver.device_aug == {"views": 2, "preset": "MOCOV2"}
    step, seen = solver._train_step, []

    def recording(state, batch):
        seen.append((batch["images"].dtype, tuple(batch["images"].shape)))
        return step(state, batch)

    solver._train_step = recording
    solver.train()
    assert seen == [(torch.uint8, (4, 224, 224, 6))] * 2
    losses = [v for _, v in _scalars(tmp_path, "loss")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    batch = {"images": torch.zeros(4, 224, 224, 6)}
    with pytest.raises(TypeError, match="uint8 geometry crops"):
        step(solver.state, batch)


# 20 synthetic images in batches of 16 (the tail batch padded), 10 classes
DENSE_TEST = {"type": "clip", "read_from": "synthetic", "meta_file": "20",
              "batch_size": 16, "transforms": {"type": "ONECROP"},
              "label_texts_ensemble": "prompt8"}


@pytest.fixture(scope="module")
def dense_pair(tmp_path_factory):
    """tiny_filip's default (dense) zero-shot eval by both solvers from one
    seeded ``.pth.tar``, untrained; the JAX solver on one CPU device."""
    import jax

    from declip_tpu.solver import Solver as JaxSolver
    from declip_tpu_torch.config import parse_config
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.solver import Solver

    root = tmp_path_factory.mktemp("dense")
    cfg = parse_config(TINY_FILIP)
    model = model_entry({"type": cfg.model.type,
                         "kwargs": {**cfg.model.kwargs, "dtype": "float32"}})
    model.init_weights(torch.Generator().manual_seed(5))
    pretrain = root / "init.pth.tar"
    torch.save({"model": model.state_dict()}, pretrain)
    sets = {"saver.pretrain.path": str(pretrain), "data.test": [DENSE_TEST]}
    out = {"jax_solver": JaxSolver(
               _cfg("declip_tpu", root / "jax", TINY_FILIP, sets),
               devices=jax.devices()[:1]),
           "port_solver": Solver(_cfg("declip_tpu_torch", root / "port",
                                      TINY_FILIP, sets), device="cpu")}
    for key in ("jax", "port"):
        metrics = out[f"{key}_solver"].evaluate(DENSE_TEST)
        out[key] = (metrics, _results(root / key))
    return out


def test_dense_zero_shot_scores_match_jax(dense_pair):
    """FILIP evaluates dense by default in both packages (the port through
    K3's plain version here), with the same scores; ``dense_eval: false``
    takes the pooled path instead."""
    port = dense_pair["port_solver"]
    assert port.method == "filip" and port.dense_eval(DENSE_TEST)
    assert not port.dense_eval({**DENSE_TEST, "dense_eval": False})
    (want_m, want), (got_m, got) = dense_pair["jax"], dense_pair["port"]
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert (g["image_id"], g["label"]) == (w["image_id"], w["label"])
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-4)
    assert (got_m["top1"], got_m["top5"]) == (want_m["top1"], want_m["top5"])


def test_dense_class_embeddings_match_jax(dense_pair):
    port, jax_solver = dense_pair["port_solver"], dense_pair["jax_solver"]
    dataset, _ = port._eval_loader(DENSE_TEST)
    label_texts, ensemble = dataset.get_label_texts()
    n_class = ensemble.shape[0]
    want = jax_solver._dense_class_embeddings(
        jax_solver.state.params, label_texts, n_class)
    with port._eval_mode() as model:
        got = port.dense_class_embeddings(model, label_texts, n_class)
    assert got.shape == (n_class, 77, 256) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("src,method,views", [
    (TINY_DEFILIP, "defilip", 2), (TINY_SLIP, "slip", 3)],
    ids=["tiny_defilip", "tiny_slip"])
def test_tiny_methods_end_to_end_through_main(tmp_path, src, method, views):
    """``main`` trains tiny_defilip (MOCOV2, EDA, MLM, the bank, the filip
    term) and tiny_slip (SLIP's base and two strong views) for 2 steps as
    configured, saves, and evaluates zero-shot: DeFILIP dense, SLIP
    pooled."""
    from declip_tpu_torch.solver import main

    shutil.copy(src, tmp_path / "config.yaml")
    solver = main(["--config", str(tmp_path / "config.yaml"), "--device",
                   "cpu", "--set", "lr_scheduler.kwargs.max_iter=2",
                   "saver.save_freq=2", "saver.print_freq=1",
                   "data.test=" + json.dumps(TEST16)])
    st = solver.state
    assert solver.method == method and st.step == 2
    assert solver.dense_eval(TEST16[0]) == (method == "defilip")
    terms = {"defilip": ("clip_loss", "simsiam_loss", "text_mlm_loss",
                         "clip_nn_text_loss", "filip_loss"),
             "slip": ("clip_loss", "simclr_loss")}[method]
    for tag in ("loss",) + terms:
        values = [v for _, v in _scalars(tmp_path, tag)]
        assert len(values) == 2 and np.isfinite(values).all(), tag
    assert [v for _, v in _scalars(tmp_path, "update_skipped")] == [0.0] * 2
    if method == "defilip":
        assert st.bank_text.ptr == 2 * 4 * 2
    batch = next(iter(solver._train_loader(-1)))
    assert batch["images"].shape[-1] == 3 * views
    assert "ckpt_2.pth.tar" in os.listdir(tmp_path / "checkpoints")
    results = _results(tmp_path)
    assert len(results) == 16 and all(len(r["score"]) == 10
                                      for r in results)


REFERENCE = {  # experiment: (method, dense eval, image tower)
    "clip_experiments/yfcc15m/yfcc15m_r50_clip": ("clip", False, "r50"),
    "clip_experiments/yfcc15m/yfcc15m_vit_clip": ("clip", False, "vit"),
    "clip_experiments/yfcc15m/yfcc15m_vit_siglip": ("clip", False, "vit"),
    "declip_experiments/yfcc15m/yfcc15m_r50_declip": ("declip", False,
                                                      "r50"),
    "declip_experiments/yfcc15m/yfcc15m_vit_declip": ("declip", False,
                                                      "vit"),
    "declip_experiments/declip88m/declip88m_r50_declip": ("declip", False,
                                                          "r50"),
    "declip_experiments/declip88m/declip88m_vitb32_declip": ("declip", False,
                                                             "vit"),
    "defilip_experiments/yfcc15m/yfcc15m_vit_defilip": ("defilip", True,
                                                        "vit"),
    "slip_experiments/yfcc15m/yfcc15m_vit_slip": ("slip", False, "vit"),
    "slip_experiments/yfcc15m/yfcc15m_r50_slip": ("slip", False, "r50"),
    "filip_experiments/yfcc15m/yfcc15m_vit_filip": ("filip", True, "vit"),
    "filip_experiments/yfcc15m/yfcc15m_r50_filip": ("filip", True, "r50"),
}


# the optimizer rule and loss kind of the configs that do not train with
# AdamW and the full loss
OPTIMIZERS = {
    "clip_experiments/yfcc15m/yfcc15m_vit_siglip": ("AdafactorRule",
                                                    "sigmoid_ring"),
    "declip_experiments/declip88m/declip88m_vitb32_declip": ("SGDRule",
                                                             "full")}


# the towers cut to one narrow layer for the Solver's build on the CPU
NARROW = {"vit": {"model.kwargs.image_encode.layers": 1,
                  "model.kwargs.image_encode.width": 64,
                  "model.kwargs.image_encode.heads": 2},
          "r50": {"model.kwargs.image_encode.layers": [1, 1, 1, 1],
                  "model.kwargs.image_encode.width": 8,
                  "model.kwargs.image_encode.heads": 4}}


@pytest.mark.parametrize("exp", list(REFERENCE))
def test_reference_config_builds_a_solver(tmp_path, exp):
    """Every reference config under experiments/ (CLIP, SigLIP, DeCLIP,
    DeCLIP-88M, DeFILIP, SLIP, FILIP), as its file has it: the model at
    full width on the meta device (shapes only), and a Solver on the CPU
    with the towers cut to one narrow layer and DeCLIP's bank to 1,024 rows
    (the training data read from the synthetic set), with the config's
    optimizer and loss kind, whose test entries evaluate as the JAX package
    decides: dense for the FILIP family, pooled for the others."""
    from declip_tpu_torch.config import override
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.models.resnet import ModifiedResNet
    from declip_tpu_torch.solver import Solver
    from declip_tpu_torch.train import method_of

    method, dense, tower = REFERENCE[exp]
    src = os.path.join(REPO, "experiments", exp, "config.yaml")
    cfg = _cfg("declip_tpu_torch", tmp_path, src, {
        "data.train.read_from": "synthetic", "data.train.meta_file": "16"})
    model = model_entry({"type": cfg.model.type, "kwargs": {
        **cfg.model.kwargs, "dtype": cfg.precision.dtype}}, device="meta")
    assert method_of(model) == method
    assert next(model.parameters()).device.type == "meta"
    vis, txt = model.visual, model.encode_text
    assert (txt.ln_final.normalized_shape[0],
            len(txt.transformer.resblocks)) == (512, 12)
    if tower == "vit":
        assert (vis.width, len(vis.transformer.resblocks),
                vis.patch_size) == (768, 12, 32)
    else:
        assert isinstance(vis, ModifiedResNet) and \
            (vis.layers, vis.width) == ((3, 4, 6, 3), 64)
    if dense:
        assert model.image_mapping.out_features == 256
    if method == "slip":
        assert model.predictor_sim.linear3.out_features == 256

    sets = {**NARROW[tower], "model.kwargs.text_encode.transformer_layers": 1,
            "model.kwargs.text_encode.transformer_width": 64,
            "model.kwargs.text_encode.transformer_heads": 2}
    if method == "declip":  # the bank cut to 1,024 rows on the CPU
        sets["model.kwargs.clip.nn_size"] = 1024
    if cfg.get_path("saver.pretrain.path"):  # a file of the reference's
        sets["saver.pretrain.path"] = None
    for key, value in sets.items():
        cfg = override(cfg, key, value)
    solver = Solver(cfg, device="cpu")
    assert solver.method == method
    assert [solver.dense_eval(t) for t in solver.test_cfgs] == [dense]
    if method == "slip":
        assert solver.train_cfg["transforms"] == {"type": "SLIP"}
    if method == "defilip":
        assert tuple(solver.state.bank_text.bank.shape) == (2 ** 16, 512)
    if method == "declip":
        assert tuple(solver.state.bank_text.bank.shape) == (
            1024, cfg.model.kwargs.clip.feature_dim)
    optimizer, loss_impl = OPTIMIZERS.get(exp, ("AdamRule", "full"))
    assert type(solver.tx).__name__ == optimizer
    assert cfg.get("loss_impl", {"type": "full"})["type"] == loss_impl
    if "siglip" in exp:
        assert float(solver.state.params["logit_bias"][0]) == -10.0

@pytest.mark.parametrize("start,num,max_iter,traced",
                         [(2, 2, 4, 3), (3, 5, 4, 2)],
                         ids=["inside", "past_max_iter"])
def test_profile_key_writes_a_trace(tmp_path, start, num, max_iter, traced):
    """``profile: {enable, start_step, num_steps}`` traces the steps that
    take the step count to ``start`` through ``start + num`` (num + 1
    steps, the JAX package's window) into ``events/profile`` (one
    tensorboard trace file); where the window runs past ``max_iter`` the
    port stops the profiler at the loop's end and still writes what it
    traced."""
    from declip_tpu_torch.solver import main

    shutil.copy(TINY_CLIP, tmp_path / "config.yaml")
    main(["--config", str(tmp_path / "config.yaml"), "--device", "cpu",
          "--set", f"lr_scheduler.kwargs.max_iter={max_iter}",
          "saver.save_freq=0", "data.test=[]",
          "profile=" + json.dumps({"enable": True, "start_step": start,
                                   "num_steps": num})])
    traces = list((tmp_path / "events" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    # K1's operator once a layer of each tower a traced step (K2 is an
    # operator of its own)
    kwargs = _cfg("declip_tpu_torch", tmp_path / "c", TINY_CLIP,
                  {}).model.kwargs
    layers = (kwargs.image_encode.layers
              + kwargs.text_encode.transformer_layers)
    k1 = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"
          and e.get("name") == "declip_tpu_torch::flash_attn_fwd"]
    assert len(k1) == traced * layers


def test_no_profile_key_writes_no_trace(pair_run):
    assert (pair_run["port"] / "events").is_dir()
    assert not (pair_run["port"] / "events" / "profile").exists()
