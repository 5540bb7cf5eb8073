"""The port stands alone: no JAX, no declip_tpu, no silent CPU fallback."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
from torch_threads import single_thread_env

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "declip_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "declip_tpu")
# the modules of the last single-card slice; hf_text imports transformers
# only when a tower is built
SLICE_MODULES = ("declip_tpu_torch.models.hf_text",
                 "declip_tpu_torch.tools.text_visualize",
                 "declip_tpu_torch.tools.linear_probe",
                 "declip_tpu_torch.tools.learnability",
                 "declip_tpu_torch.data.synthetic_shapes",
                 "declip_tpu_torch.data.shapes_batches",
                 "declip_tpu_torch.utils.mixup",
                 "declip_tpu_torch.utils.debug")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import declip_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(declip_tpu_torch.__path__,\n"
        "                               'declip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
        "print('MODULES', sum(m.startswith('declip_tpu_torch.') for m in sys.modules))\n"
        f"print('SLICE', [m for m in {SLICE_MODULES!r} if m not in sys.modules])\n"
        "print('TRANSFORMERS', 'transformers' in sys.modules)\n"
    )
    env = single_thread_env(PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1].split()[0])
    assert n >= len(list(PORT.rglob("*.py"))) - 1  # every module, bar __init__
    assert "SLICE []" in out.stdout, out.stdout
    assert "TRANSFORMERS False" in out.stdout, out.stdout


def test_operator_calls_import_no_dynamo():
    """Calling the registered kernels (``ops/_oplib.py``; on CPU tensors
    their plain versions), forward and backward, imports neither
    ``torch._dynamo`` nor sympy: the registration adds no Python
    dispatch layers to a call, and a training process keeps its import
    set (``torch.library.custom_op`` imported both at its first call)."""
    code = (
        "import sys, torch\n"
        "from declip_tpu_torch.ops.flash_attention import flash_attention\n"
        "from declip_tpu_torch.ops.filip_late_interaction import (\n"
        "    late_interaction_logits_kernel)\n"
        "q = torch.randn(2, 2, 9, 16, requires_grad=True)\n"
        "flash_attention(q, q, q, causal=True).sum().backward()\n"
        "with torch.no_grad():\n"
        "    flash_attention(q, q, q)\n"
        "d1 = torch.randn(2, 5, 8, requires_grad=True)\n"
        "d2 = torch.randn(3, 4, 8, requires_grad=True)\n"
        "late_interaction_logits_kernel(d1, d2, torch.tensor(2.0))"
        ".sum().backward()\n"
        "assert q.grad is not None and d2.grad is not None\n"
        "print('LOADED', sorted(m for m in ('torch._dynamo', 'sympy')\n"
        "                       if m in sys.modules))\n"
    )
    env = single_thread_env(PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_serve_main_refuses_absent_cuda(tmp_path, monkeypatch):
    """--device cuda (the default) raises where CUDA is absent; it does not
    run on the CPU instead."""
    import torch

    from declip_tpu_torch.tools import serve

    cfg = tmp_path / "config.yaml"
    cfg.write_text("model: {type: clip_vitb32, kwargs: {}}\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--device", "cuda", "--config", str(cfg)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--config", str(cfg)])


@pytest.mark.parametrize("flag", [["--int8"], ["--stablehlo", "dir"]])
def test_serve_main_rejects_unported_flags(tmp_path, flag, capsys):
    """``--stablehlo`` is refused, naming ``--exported``: the port cannot
    run StableHLO. ``--int8`` with an artifact is refused, naming
    ``--quantize int8``, as in the JAX package (an artifact is quantized
    when it is exported)."""
    from declip_tpu_torch.tools import serve

    src = ["--exported", str(tmp_path)] if flag == ["--int8"] else []
    with pytest.raises(SystemExit) as e:
        serve.main([*src, "--device", "cpu", *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("--quantize int8" if flag == ["--int8"] else
            "--exported DIR") in err


def test_chip_smoke_fails_without_cuda():
    """With no card visible the smoke script exits non-zero and prints no
    result line."""
    env = single_thread_env(CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_data_path_imports_no_torch():
    """The host data path (what ``worker_type: process`` workers and the
    learnability run's batch worker import) loads neither torch nor JAX:
    a spawned worker never touches CUDA."""
    code = (
        "import sys\n"
        "import declip_tpu_torch.data.dataloader, declip_tpu_torch.data.dataset\n"
        "import declip_tpu_torch.data.evaluator, declip_tpu_torch.data.sampler\n"
        "import declip_tpu_torch.data.transforms, declip_tpu_torch.tokenizer\n"
        "import declip_tpu_torch.data.wds, declip_tpu_torch.data.native\n"
        "import declip_tpu_torch.data.imagenet\n"
        "import declip_tpu_torch.data.synthetic_shapes\n"
        "import declip_tpu_torch.data.shapes_batches\n"
        "import declip_tpu_torch.tools.make_wds\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        "                       if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    env = single_thread_env(PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("alias", ["clip", "slip", "filip", "declip",
                                   "defilip"])
def test_solver_aliases_run_the_one_engine(alias):
    import importlib

    from declip_tpu_torch import solver

    mod = importlib.import_module(f"declip_tpu_torch.solver.{alias}_solver")
    assert mod.main is solver.main


def test_solver_cli_refuses_absent_cuda(tmp_path):
    """``python -m declip_tpu_torch.solver`` with no --device and no card
    exits non-zero naming the missing CUDA, and trains nothing."""
    import shutil

    shutil.copy(REPO / "experiments" / "unit" / "tiny_clip" / "config.yaml",
                tmp_path / "config.yaml")
    env = single_thread_env(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "declip_tpu_torch.solver", "--config",
         str(tmp_path / "config.yaml")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "checkpoints").exists()
