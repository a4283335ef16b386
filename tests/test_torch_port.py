"""Rules of the port as a package: it imports neither ``jax`` nor
anything of the reference package, and its entry points refuse to run on
the CPU unless asked (``device="cpu"``)."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import baselines
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.control import (ControlKnobs, ControlledAccMPEGPolicy,
                                 RateController, lte_trace)
from repro_torch.core.accmodel import AccModel
from repro_torch.core.training import accmodel_init
from repro_torch.engine import EngineConfig, StreamingEngine
from repro_torch.models import DecoderLM, Stack
from repro_torch.models import layers as L
from repro_torch.models.rwkv6 import RWKV6ChannelMix, RWKV6TimeMix
from repro_torch.serve.tenants import TenantSpec
from repro_torch.vision.dnn import FinalDNN, render_detection_targets
from repro_torch.vision.train import train_final_dnn

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("codec/dct.py", "codec/codec.py", "kernels/build.py",
                   "kernels/mbcodec/ref.py", "kernels/mbcodec/kernel.py",
                   "kernels/mbcodec/ops.py", "vision/dnn.py",
                   "core/quality.py", "core/accmodel.py", "core/pipeline.py",
                   "engine/engine.py", "engine/policies.py", "data/video.py",
                   "weights.py", "serve/__init__.py", "serve/steps.py",
                   "engine/config.py", "engine/multistream.py",
                   "kernels/accgrad_reduce/ref.py",
                   "kernels/accgrad_reduce/kernel.py",
                   "kernels/accgrad_reduce/ops.py", "core/accgrad.py",
                   "core/training.py", "vision/train.py",
                   "configs/base.py", "configs/smollm_360m.py",
                   "configs/rwkv6_1b6.py", "kernels/decode_attn/ref.py",
                   "kernels/decode_attn/kernel.py",
                   "kernels/decode_attn/ops.py", "kernels/wkv6/ref.py",
                   "kernels/wkv6/kernel.py", "kernels/wkv6/ops.py",
                   "models/layers.py", "models/rwkv6.py",
                   "models/transformer.py", "control/__init__.py",
                   "control/traces.py", "control/controller.py",
                   "baselines/__init__.py", "baselines/baselines.py",
                   "core/aggregate.py", "control/autoscaler.py",
                   "control/workload.py", "obs/__init__.py",
                   "obs/metrics.py", "obs/trace.py", "obs/compile.py",
                   "serve/tenants.py", "checkpoint/__init__.py",
                   "checkpoint/manager.py"):
        assert f"src/repro_torch/{module}" in names
    assert "chip_smoke.py" in names
    for source in ("mbcodec/csrc/mbcodec.cu",
                   "accgrad_reduce/csrc/accgrad_reduce.cu",
                   "decode_attn/csrc/decode_attn.cu", "wkv6/csrc/wkv6.cu"):
        assert (ROOT / "src/repro_torch/kernels" / source).is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.data import video\n"
                   "from . import sibling\nimport repro_torch\n")
    assert [m for m in _imported_roots(src) if m in FORBIDDEN] == \
        ["jax", "repro"]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")


def test_entry_points_default_to_cuda_and_refuse_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FinalDNN("detection", 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AccModel(8)
    dnn = FinalDNN("detection", 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEngine(dnn)
    assert StreamingEngine(dnn, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_final_dnn("detection", "dashcam", steps=1, H=32, W=32,
                        width=8, cache=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        accmodel_init(0, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_detection_targets([[]], 32, 32)
    # the baselines, trace mode and the rate-controlled policy
    frames = torch.zeros(10, 32, 32, 3).numpy()
    for run, extra in ((baselines.run_uniform, (38,)),
                       (baselines.run_dds, ()), (baselines.run_eaar, ()),
                       (baselines.run_reducto, ()),
                       (baselines.run_vigil, (dnn,))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(frames, dnn, *extra)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEngine(dnn, trace=lte_trace(), controller=RateController())
    ctrl = RateController()
    assert StreamingEngine(dnn, trace=lte_trace(), controller=ctrl,
                           device="cpu").trace.genre == "lte"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctrl.knob_array()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ControlKnobs(0.3, 30.0, 40.0, 0.0).as_array()
    policy = ControlledAccMPEGPolicy(AccModel(8, device="cpu"), ctrl)
    assert policy.controller.knob_array("cpu").device.type == "cpu"


def test_lm_defaults_to_cuda_and_refuses_without_it():
    _no_cuda()
    cfg = get_reduced_config("smollm-360m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM(cfg, device="cuda")
    assert DecoderLM(cfg, device="cpu").device.type == "cpu"


_LM_MODULES = {
    "Stack": lambda **kw: Stack(get_reduced_config("rwkv6-1.6b"), **kw),
    "Linear": lambda **kw: L.Linear(8, 4, bias=True, **kw),
    "Embedding": lambda **kw: L.Embedding(16, 8, **kw),
    "Norm": lambda **kw: L.Norm(8, "layernorm", **kw),
    "Attention": lambda **kw: L.Attention(8, 2, 1, 4, **kw),
    "MLP": lambda **kw: L.MLP(8, 16, **kw),
    "RWKV6TimeMix": lambda **kw: RWKV6TimeMix(8, 4, 2, 2, **kw),
    "RWKV6ChannelMix": lambda **kw: RWKV6ChannelMix(8, 16, **kw),
}


@pytest.mark.parametrize("name", sorted(_LM_MODULES))
def test_lm_modules_default_to_cuda_and_refuse_without_it(name):
    _no_cuda()
    build = _LM_MODULES[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    params = list(build(device="cpu").parameters())
    assert params and all(p.device.type == "cpu" for p in params)


def test_lm_rejects_unported_archs_and_layers():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("olmoe-1b-7b")
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")
    cfg = get_reduced_config("smollm_360m")
    for bad in (dict(block_pattern=(("mamba", "mlp"),)),
                dict(block_pattern=(("attn", "moe"),)),
                dict(enc_dec=True), dict(cross_attn_every=5),
                dict(kv_cache_dtype="int8")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DecoderLM(dataclasses.replace(cfg, **bad), device="cpu")


def test_engine_rejects_unported_modes_and_unknown_backends():
    """Both engines take a trace and a controller, the fleet the
    autoscaler too (ROADMAP module 6) and tenants (module 7); the fleet's
    config still refuses the stream mesh (module 8), and a tenant that is
    not a ``TenantSpec`` or a ``tenant_of`` without tenants."""
    dnn = FinalDNN("detection", 8, device="cpu")
    for field in ("trace", "controller", "autoscaler"):
        assert getattr(EngineConfig(**{field: dnn}), field) is dnn
    for field, value, module in (("mesh", "auto", "module 8"),):
        with pytest.raises(NotImplementedError, match=module):
            EngineConfig(**{field: value})
    spec = TenantSpec("t", dnn, AccModel(8, device="cpu"))
    assert EngineConfig(tenants=(spec,)).tenants == (spec,)
    with pytest.raises(AttributeError):
        EngineConfig(tenants=(dnn,))
    with pytest.raises(ValueError, match="without tenants"):
        EngineConfig(tenant_of={0: 0})
    with pytest.raises(ValueError, match="unknown chunk encoder"):
        StreamingEngine(dnn, device="cpu", impl="nope")


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
