"""The port stands alone: no JAX, nothing of ``paddle_tpu``, no silent CPU.

``paddle_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
``paddle_tpu`` nor ``ml_dtypes`` (they run on a machine with none of
them), and the port's entry points default to CUDA: without a card they
raise instead of running on the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p for p in (REPO / "paddle_tpu_torch").rglob("*.py")
                    if "_build" not in p.parts) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_paddle_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_with_poisoned_jax(tmp_path):
    """Every module of the port imports with ``jax`` and ``paddle_tpu``
    poisoned on the path, and none of them pulls either in."""
    for name in FORBIDDEN:
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is poisoned for this test')\n")
    mods = sorted({".".join(p.relative_to(REPO).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in PORT_FILES if p.name != "chip_smoke.py"})
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_to_run_on_cpu_without_being_asked(monkeypatch):
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import Engine, PagedKVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(**GPT_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(GPTForCausalLM(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(1, 1, 1, 16, 8)
    assert resolve_device("cpu").type == "cpu"


def test_train_step_refuses_to_run_on_cpu_without_being_asked(monkeypatch):
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu")
    opt = AdamW(parameters=model.named_parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_train_step(model, opt)
    step = make_sharded_train_step(model, opt, device="cpu")
    assert step.device.type == "cpu"


def test_distributed_entry_points_refuse_to_run_on_cpu_without_being_asked(
        monkeypatch):
    """``init_parallel_env``, ``fleet.init`` and ``spawn`` join the world on
    the card unless asked for the CPU; nothing is set up before they
    raise."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (dist.init_parallel_env, fleet.init,
                 lambda: dist.spawn(lambda: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not dist.is_initialized()
    assert fleet.get_hybrid_communicate_group() is None


def test_data_feed_refuses_to_run_on_cpu_without_being_asked(monkeypatch,
                                                            tmp_path):
    from paddle_tpu_torch.data import GlobalBatchFeeder, build_pretrain_pipeline
    from paddle_tpu_torch.io import DevicePrefetcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.bin").write_bytes(bytes(64))
    for make in (lambda: DevicePrefetcher([]),
                 lambda: GlobalBatchFeeder(iter([])),
                 lambda: build_pretrain_pipeline(str(tmp_path / "a.bin"), 1,
                                                 8, chunk_len=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert DevicePrefetcher([], device="cpu") is not None


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """No result without a card, and none from a copy of the script with
    nothing else of the repo beside it."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}  # hide any card
    for script in (REPO / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
