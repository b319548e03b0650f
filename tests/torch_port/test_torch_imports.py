"""The port stands alone: no file of ``paddle_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package, importing the port
leaves jax out of ``sys.modules``, and its entry points default to CUDA
and refuse to run without it."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "paddle_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_paddle_tpu_import(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.generation, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.kernels, "
            "paddle_tpu_torch.kernels.flash_attention, "
            "paddle_tpu_torch.kernels.quant_matmul, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.nn.quant, paddle_tpu_torch.quantization, "
            "paddle_tpu_torch.quantization.intx, "
            "paddle_tpu_torch.quantization.observers, "
            "paddle_tpu_torch.quantization.ptq_serving, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.kernels.fused_conv, "
            "paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.nn.layers_conv_norm, "
            "paddle_tpu_torch.nn.layout, paddle_tpu_torch.vision, "
            "paddle_tpu_torch.vision.models.resnet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, max_slots=1, max_len=64)
    assert resolve_device("cpu").type == "cpu"


def test_quantized_entry_points_default_to_cuda(monkeypatch):
    """The quantized path adds no way around the device rule: a converted
    model still lives where it was built, and the engine and caches
    resolve ``None`` to CUDA."""
    from paddle_tpu_torch.generation import make_kv_caches
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import convert_for_serving
    from paddle_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = convert_for_serving(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), fmt="int8")
    assert model.lm_head.qweight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, max_slots=1, max_len=64, kv_format="int8")
    caches = make_kv_caches(model.config, 1, 8, torch.float32, "fp8")
    assert caches[0]["k"].device.type == "cpu"


def test_resnet_entry_points_default_to_cuda(monkeypatch):
    """A ResNet resolves ``device=None`` to CUDA and raises without it;
    built on the CPU on request, its fused units run the plain versions
    (no launch) and its train step stays on the CPU."""
    from paddle_tpu_torch.distributed import ShardedTrainStep
    from paddle_tpu_torch.kernels import fused_conv
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import to_channels_last
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18, resnet50

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ctor in (resnet18, resnet50):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctor(num_classes=10)
    model = to_channels_last(resnet18(num_classes=10, device="cpu"))
    assert all(p.device.type == "cpu" for p in model.parameters())
    # casting the model casts the BatchNorm buffers too, as the JAX
    # package's Layer.to does
    assert {b.dtype for b in model.to(torch.bfloat16).buffers()} \
        == {torch.bfloat16}
    model.float()
    fused_conv.reset_counters()
    step = ShardedTrainStep(model, lambda lo, la: F.cross_entropy(lo, la),
                            Momentum(learning_rate=0.01))
    loss = step.step(torch.randn(2, 3, 32, 32), torch.tensor([1, 2]))
    assert loss.device.type == "cpu"
    assert sum(fused_conv.LAUNCHES.values()) == 0


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
