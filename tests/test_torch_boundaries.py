"""Boundaries of the port: it never reaches into JAX or the JAX package,
and a request for the card never quietly runs on the CPU."""

import ast
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (H100_SXM, WallClockEvaluator,  # noqa: E402
                              device_profile)
from repro_torch.kernels import attention as fa_pkg  # noqa: E402
from repro_torch.kernels import conv2d as cv_pkg  # noqa: E402
from repro_torch.kernels import matmul as mm_pkg  # noqa: E402

# the package's ``matmul`` attribute is the op; the module holds the wrapper
mm_mod = importlib.import_module("repro_torch.kernels.matmul.matmul")
cv_mod = importlib.import_module("repro_torch.kernels.conv2d.conv2d")
fa_mod = importlib.import_module("repro_torch.kernels.attention.flash")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        assert "torch" not in dirnames and "triton" not in dirnames
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package_imports(path):
    assert os.path.exists(path)
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_gpu(monkeypatch):
    """A host without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_wallclock_evaluator_defaults_to_the_card_and_raises_without_one(
        no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        WallClockEvaluator()
    assert WallClockEvaluator(device="cpu").device.type == "cpu"


def test_device_profile_needs_the_card_unless_asked_for_the_cpu(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        device_profile()
    assert device_profile("cpu") is H100_SXM


def test_matmul_on_cuda_tensors_without_a_card_raises(no_gpu, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("computed on the CPU")

    monkeypatch.setattr(mm_mod, "gemm_plain", plain_must_not_run)
    before = dict(mm_mod.LAUNCHES)
    cfg = {"BLOCK_M": 64, "BLOCK_N": 64, "BLOCK_K": 32}
    with FakeTensorMode():
        a = torch.empty(256, 256, device="cuda")
        b = torch.empty(256, 256, device="cuda")
        assert a.device.type == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mm_pkg.matmul(a, b, config=cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            mm_pkg.matmul(a, b)                  # config from the registry
    assert mm_mod.LAUNCHES == before


def test_conv2d_on_cuda_tensors_without_a_card_raises(no_gpu, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("computed on the CPU")

    monkeypatch.setattr(cv_mod, "conv2d_plain", plain_must_not_run)
    before = dict(cv_mod.LAUNCHES)
    with FakeTensorMode():
        img = torch.empty(64, 256, device="cuda")
        f = torch.empty(3, 3, device="cuda")
        for cfg in ({"BLOCK_H": 16, "BLOCK_W": 128},
                    {"HALO_MODE": "xla"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cv_pkg.conv2d(img, f, config=cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            cv_pkg.conv2d(img, f)                 # config from the registry
    assert cv_mod.LAUNCHES == before


def test_flash_attention_on_cuda_tensors_without_a_card_raises(no_gpu,
                                                                monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("computed on the CPU")

    monkeypatch.setattr(fa_mod, "flash_plain", plain_must_not_run)
    before = dict(fa_mod.LAUNCHES)
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64}
    with FakeTensorMode():
        q = torch.empty(2, 128, 64, device="cuda")
        assert q.device.type == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fa_pkg.flash_attention(q, q, q, config=cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            fa_pkg.flash_attention(q, q, q)       # config from the registry
    assert fa_mod.LAUNCHES == before


def test_models_need_the_card_unless_asked_for_the_cpu(no_gpu):
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_model, params_from_numpy

    cfg = get_config("granite-3-2b", smoke=True)
    for call in (lambda: init_model(cfg, 0), lambda: init_cache(cfg, 1, 8),
                 lambda: params_from_numpy({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params = init_model(cfg, 0, "cpu")
    assert params["embed"].device.type == "cpu"
    assert init_cache(cfg, 1, 8, "cpu")["blocks"]["k"].device.type == "cpu"


def test_serve_engine_and_launcher_need_the_card(no_gpu):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import BucketedServeEngine, ServeEngine

    cfg = get_config("granite-3-2b", smoke=True)
    with FakeTensorMode():
        params = {"embed": torch.empty(cfg.vocab_size, cfg.d_model,
                                       device="cuda")}
    for engine in (ServeEngine, BucketedServeEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine(cfg, params, online_tune=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--device", "cuda:0"])


def test_training_needs_the_card_unless_asked_for_the_cpu(no_gpu, tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.dist.step import make_train_step
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_model
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config("granite-3-2b", smoke=True)
    data = DataConfig(seq_len=8, global_batch=2, vocab_size=cfg.vocab_size)
    tc = TrainerConfig(ckpt_dir=str(tmp_path / "t"))
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, data, tc, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "l")])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg, 0, device="cuda")
    assert not os.listdir(tmp_path)             # nothing was written
    with FakeTensorMode():
        params = {"embed": torch.empty(cfg.vocab_size, cfg.d_model,
                                       device="cuda")}
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)(params, None, {})
    t = Trainer(cfg, data, tc, device="cpu")
    t.init_state()
    assert t.params["embed"].device.type == "cpu"
    assert t.opt_state.count.device.type == "cpu"


def test_distribution_entry_points_default_to_the_card():
    """Meshes, the dry-run and the sharding tuner lay tensors out on the
    card's device type unless the caller asks for the CPU; the dry-run's
    fake world is entered and left inside a call and refuses to take over
    an existing process group."""
    import inspect

    from repro_torch.launch import dryrun, mesh
    from repro_torch.runtime import elastic
    from repro_torch.tune import CellObjective

    for fn in (mesh.make_production_mesh, mesh.make_host_mesh,
               elastic.make_elastic_mesh, dryrun.analyze_cell,
               dryrun.cell_costs, dryrun.run_cells):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda", fn.__name__
    assert CellObjective("mamba2-130m", "decode_32k").device_type == "cuda"
    assert not torch.distributed.is_initialized()
    with dryrun.fake_world(4):
        assert torch.distributed.get_world_size() == 4
        with pytest.raises(RuntimeError, match="process group"):
            with dryrun.fake_world(2):
                pass
    assert not torch.distributed.is_initialized()


#: what lays a model out over a mesh, and so stays in ``dist/sharding.py``:
#: the spec-level calls and the mesh axes' own names
LAYOUT_CALLS = ("scope_spec", "local_range", "spec_for", "chunk_of",
                "placements")
MESH_AXES = ("data", "model", "pod")


def _model_files():
    models = os.path.join(PORT, "models")
    return sorted(os.path.join(models, f) for f in os.listdir(models)
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", _model_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_models_name_logical_axes_only(path):
    """The models tag dims with logical axes and call ``shard`` and the
    layout helpers of ``dist/sharding.py`` (``run_local`` over logical
    axes, ``rank_slice``, ``is_split``, ``relayout``, ``project_heads``):
    no call to a spec-level function, no import of ``Spec``, no string
    equal to a mesh axis's name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in LAYOUT_CALLS:
                bad.append(f"call {name} (line {node.lineno})")
        elif isinstance(node, ast.ImportFrom):
            bad += [f"import {a.name} (line {node.lineno})"
                    for a in node.names
                    if a.name in LAYOUT_CALLS + ("Spec",)]
        elif isinstance(node, ast.Name) and node.id == "Spec":
            bad.append(f"name Spec (line {node.lineno})")
        elif isinstance(node, ast.Constant) and node.value in MESH_AXES:
            bad.append(f"string {node.value!r} (line {node.lineno})")
    assert not bad, bad
