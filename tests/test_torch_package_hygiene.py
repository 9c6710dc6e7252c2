"""The port stands alone: no JAX, flax, pydantic or ``deepspeed_tpu``
import anywhere in ``deepspeed_tpu_torch`` or ``chip_smoke.py``, importing
it leaves JAX unloaded, and its entry points never run on the CPU unless
asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pydantic", "deepspeed_tpu"}


def _port_files():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    # modules an interpreter start-up hook loaded already are not the
    # port's doing: compare against what was loaded before the import
    code = ("import sys; before = set(sys.modules); "
            "import deepspeed_tpu_torch, deepspeed_tpu_torch.inference.engine, "
            "deepspeed_tpu_torch.ops.transformer.registry, "
            "deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.runtime.dataloader; "
            "bad = [m for m in ('jax', 'flax', 'pydantic', 'deepspeed_tpu') "
            "if m in sys.modules and m not in before]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _tiny_model():
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    return Transformer(TransformerConfig(vocab_size=97, hidden_size=64,
                                         num_layers=1, num_heads=4,
                                         dtype="float32"))


def test_default_device_is_cuda_and_never_silently_cpu(monkeypatch):
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    # the JAX suite's accelerator switch must not move the port
    monkeypatch.setenv("DSTPU_ACCELERATOR", "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(_tiny_model())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_inference(_tiny_model(), dtype="float32")
    eng = init_inference(_tiny_model(), dtype="float32", device="cpu")
    assert eng.device.type == "cpu"


def test_training_default_device_is_cuda(monkeypatch):
    from deepspeed_tpu_torch import initialize
    monkeypatch.setenv("DSTPU_ACCELERATOR", "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    config = {"train_micro_batch_size_per_gpu": 1}
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize(model=_tiny_model(), config=config)
    engine, *_ = initialize(model=_tiny_model(), config=config, device="cpu")
    assert engine.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in engine.module.parameters())


def test_unported_config_knobs_raise():
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    for knob in (dict(quant={"enabled": True}), dict(quant={"kv_cache": True}),
                 dict(tp={"tp_size": 2}), dict(mp_size=2),
                 dict(strict_memory=True),
                 dict(fault={"bucket_downshift": True}),
                 dict(compile_cache={"enabled": True}),
                 dict(serving={"num_slots": 4})):
        with pytest.raises(NotImplementedError):
            DeepSpeedInferenceConfig(**knob)
    cfg = DeepSpeedInferenceConfig(replace_with_kernel_inject=False,
                                   max_tokens=64, unknown_key=1)
    assert cfg.kernel_inject is False and cfg.max_out_tokens == 64
    assert cfg.unknown_key == 1


def test_hf_models_and_names_raise():
    from deepspeed_tpu_torch import init_inference
    for model in ("facebook/opt-125m", torch.nn.Linear(2, 2)):
        with pytest.raises(NotImplementedError, match="module_inject"):
            init_inference(model, device="cpu")
