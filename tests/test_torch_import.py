"""The PyTorch port stands alone: it imports neither JAX, ml_dtypes nor the
JAX package, and its entry points default to CUDA without falling back."""
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list:
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_no_ml_dtypes_no_reference_package():
    modules = _port_modules()
    assert "repro_torch.kernels.flash_attention.ops" in modules
    assert "repro_torch.kernels.ssm_scan.ops" in modules
    assert "repro_torch.models.mamba" in modules
    assert "repro_torch.kernels.wkv6.ops" in modules
    assert "repro_torch.models.rwkv6" in modules
    for name in ("kernels.int8_matmul.ops", "kernels.int8_matmul.ref",
                 "models.resnet", "core.quant", "configs.resnet18",
                 "models.attention", "models.mlp", "launch",
                 "launch.steps", "checkpoint", "checkpoint.ckpt",
                 "serving.engine", "serving.paged_cache",
                 "serving.paged_engine", "core.partition", "core.fleet",
                 "serving.overload", "serving.chaos", "kernels.registry",
                 "models.frontends", "configs.moonshot_v1_16b_a3b",
                 "configs.arctic_480b", "configs.qwen3_14b",
                 "configs.phi3_medium_14b", "configs.mistral_nemo_12b",
                 "configs.pixtral_12b", "configs.musicgen_medium",
                 "optim", "optim.adamw", "optim.schedules", "data",
                 "data.pipeline", "launch.train", "launch.serve",
                 "distributed", "distributed.sharding",
                 "distributed.collectives", "distributed.pipeline",
                 "launch.mesh", "launch.dryrun", "launch.roofline",
                 "launch.report", "launch.cost"):
        assert "repro_torch." + name in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', "
        "'repro') or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.', "
        "'repro.')))\n"
        "print(len(bad), bad)\n"
        "import torch\n"
        "print(torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "0 []", lines[0]
    assert lines[1] == "False False"        # TF32 off at import


def test_chip_smoke_imports_nothing_of_jax():
    src = (SRC.parent / "chip_smoke.py").read_text()
    for bad in ("import jax", "from jax", "ml_dtypes", "from repro.",
                "import repro.", "from repro import"):
        assert bad not in src, bad


@pytest.mark.parametrize("script", [
    "torch_quickstart.py", "torch_serve_resnet18.py", "torch_train_100m.py",
    "torch_elastic_restart.py"])
def test_torch_examples_import_nothing_of_jax(script):
    src = (SRC.parent / "examples" / script).read_text()
    for bad in ("import jax", "from jax", "ml_dtypes", "from repro.",
                "import repro.", "from repro import", "repro.launch"):
        assert bad not in src, bad


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core.executor import Executor
    from repro_torch.core.rhal import TileMesh, make_eager_driver
    from repro_torch.core.rtpm import Platform
    from repro_torch.configs.resnet18 import CONFIG
    from repro_torch.core.quant import quantize_resnet
    from repro_torch.models.resnet import init_resnet
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import PagedKVCache
    from repro_torch.serving.paged_engine import PagedServingEngine
    from repro_torch.launch import serve, train
    from repro_torch.serving import chaos
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("qwen2-1.5b-smoke")
    return {
        "ServingEngine": lambda: ServingEngine(cfg, {}),
        "ServingEngine.from_rimfs": lambda: ServingEngine.from_rimfs(
            cfg, None),
        "PagedServingEngine": lambda: PagedServingEngine(cfg, {}),
        "PagedServingEngine.from_rimfs":
            lambda: PagedServingEngine.from_rimfs(cfg, None),
        "PagedKVCache": lambda: PagedKVCache(1, 4, 4, 2, 8),
        "make_eager_driver": make_eager_driver,
        "TileMesh": lambda: TileMesh(2),
        "Executor": Executor,
        "Platform": Platform,
        "InferenceServer": InferenceServer,
        "init_params": lambda: init_params(cfg, 0),
        "init_resnet": lambda: init_resnet(CONFIG.smoke(), 0),
        "quantize_resnet": lambda: quantize_resnet(CONFIG.smoke(), {}, None),
        "chaos.gemm_workload": chaos.gemm_workload,
        "chaos.run_chaos": chaos.run_chaos,
        "chaos.run_rollout_chaos": chaos.run_rollout_chaos,
        "train.main": lambda: train.main(["--smoke", "--steps", "1"]),
        "serve.main": lambda: serve.main(["--requests", "1"]),
        "serve.serve_resnet": lambda: serve.serve_resnet(1, 1, 1, 1),
        "serve.serve_lm": lambda: serve.serve_lm(1),
        "serve.serve_fleet": lambda: serve.serve_fleet(4),
        "serve.resnet_program": serve.resnet_program,
    }


@pytest.mark.parametrize("name", ["make_eager_driver", "TileMesh",
                                  "Executor", "Platform", "InferenceServer",
                                  "init_params", "init_resnet",
                                  "quantize_resnet", "ServingEngine",
                                  "ServingEngine.from_rimfs",
                                  "PagedServingEngine",
                                  "PagedServingEngine.from_rimfs",
                                  "PagedKVCache", "chaos.gemm_workload",
                                  "chaos.run_chaos",
                                  "chaos.run_rollout_chaos",
                                  "train.main", "serve.main",
                                  "serve.serve_resnet", "serve.serve_lm",
                                  "serve.serve_fleet",
                                  "serve.resnet_program"])
def test_default_device_is_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        _entry_points()[name]()


@pytest.mark.parametrize("name", ["make_eager_driver", "Executor",
                                  "Platform"])
def test_entry_points_run_on_cpu_when_asked(name):
    from repro_torch.core.executor import Executor
    from repro_torch.core.rhal import make_eager_driver
    from repro_torch.core.rtpm import Platform
    made = {"make_eager_driver": make_eager_driver, "Executor": Executor,
            "Platform": Platform}[name](device="cpu")
    driver = made if name == "make_eager_driver" else made.driver
    assert driver.device == torch.device("cpu")
    assert driver.arena.capacity == 1 << 30
