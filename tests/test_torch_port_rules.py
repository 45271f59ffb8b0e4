"""Rules of the PyTorch/CUDA port: it imports no JAX and nothing of the JAX
package, its entry points never drop quietly to the CPU, and its kernels
build without PyTorch's headers or PyTorch's extension builder."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from simple_image_compression_network_tpu_torch import (
    _build, eval_codec, intnet, train, train_intnet, train_loop)
from simple_image_compression_network_tpu_torch.codec import hyper_codec, rans
from simple_image_compression_network_tpu_torch.models import (
    codec_int, hyperprior)
from simple_image_compression_network_tpu_torch.parallel import (
    distributed, mesh as meshlib)
from simple_image_compression_network_tpu_torch.utils import device

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "simple_image_compression_network_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import simple_image_compression_network_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke  # noqa: F401
ref = "simple_image_compression_network_tpu"
bad = [m for m in sys.modules
       if m in ("jax", "flax", "msgpack", ref)
       or m.startswith(("jax.", "flax.", "msgpack.", ref + "."))]
print(" ".join(sorted(bad)))
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke, in a fresh interpreter.
    The JAX package's name is a prefix of the port's: match it exactly or
    with its dot, never by a bare prefix."""
    res = subprocess.run([sys.executable, "-c", _PROBE, ROOT],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0, (res.stdout, res.stderr[-2000:])


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device.resolve_device(None)
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda")
    params = {f"w{i}": torch.zeros((1, 5, 5, 1), dtype=torch.int8)
              for i in range(8)}
    params.update({f"b{i}": torch.zeros((1,), dtype=torch.int8)
                   for i in range(8)})
    with pytest.raises(RuntimeError):
        codec_int.IntCodecNet(params)
    # the sharded codec's entry points: a mesh (which ShardedIntCodec and
    # eight_layers_net_sharded take their device from) and spawn_ranks
    for make in (lambda: meshlib.make_mesh((1,), ("x",)),
                 lambda: meshlib.spatial_mesh(1, device="cuda"),
                 lambda: distributed.spawn_ranks(print, 1, backend="gloo")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_hyper_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        hyperprior.ScaleHyperprior(n=4, m=6)
    ckpt = os.path.join(ROOT, "checkpoints", "hp_scale_l0.01.params.msgpack")
    with pytest.raises(RuntimeError):
        hyper_codec.HyperCodec.from_checkpoint(ckpt)
    model = hyperprior.ScaleHyperprior(n=4, m=6, device="cpu")
    assert model.device == torch.device("cpu")
    assert hyper_codec.HyperCodec(model).device == torch.device("cpu")


def test_meanscale_and_eval_entry_points_raise_without_a_card(monkeypatch):
    """The mean-scale model and codec (either dtype) and ``eval_codec.main``
    run on the card unless asked for the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(RuntimeError):
            hyperprior.MeanScaleHyperprior(n=4, m=6, dtype=dtype)
    ckpt = os.path.join(ROOT, "checkpoints",
                        "hp_meanscale_l0.01.params.msgpack")
    with pytest.raises(RuntimeError):
        hyper_codec.MeanScaleCodec.from_checkpoint(ckpt)
    for argv in (["--codec", "int8"], ["--codec", "meanscale", "--ckpt",
                                       ckpt]):
        with pytest.raises(RuntimeError):
            eval_codec.main(argv)
    model = hyperprior.MeanScaleHyperprior(n=4, m=6, device="cpu",
                                           dtype=torch.bfloat16)
    assert hyper_codec.MeanScaleCodec(model).device == torch.device("cpu")


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """``train.build_model``, ``train.init_state``, ``train_loop.main``
    (one device, --dp and --sp), intnet's trainable build and
    ``train_intnet.main`` train on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = train.TrainConfig(model="factorized", n=4, m=6)
    for make in (lambda: train.build_model(cfg),
                 lambda: train.init_state(cfg),
                 lambda: train_loop.main(["--steps", "1"]),
                 lambda: train_loop.main(["--steps", "1", "--dp", "2"]),
                 lambda: train_loop.main(["--steps", "1", "--sp", "2"]),
                 lambda: intnet.init_params(intnet.IntNetTrainConfig()),
                 lambda: train_intnet.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model, opt = train.init_state(cfg, device="cpu")
    assert model.device == torch.device("cpu") and opt.count == 0


def test_new_modules_fall_under_the_import_probe():
    """The probe walks every module of the package; the later slices'
    modules must be among them."""
    import pkgutil
    import simple_image_compression_network_tpu_torch as port
    names = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")}
    for mod in ("codec.hyper_codec", "codec.entropy", "codec.escape",
                "models.hyperprior", "ops.gdn", "utils.msgpack_io",
                "models.tiled", "codec.rans", "codec.wavelet_codec",
                "intnet_haar", "eval_codec", "utils.data", "ops.integer",
                "ops.nn", "ops.tmr", "utils.native_golden", "utils.checks",
                "utils.dump", "utils.profiling", "utils.cache",
                "parallel.mesh", "parallel.distributed", "parallel.spatial",
                "parallel.entropy_sharded", "parallel.hyper_sharded",
                "train", "train_loop", "utils.train_ckpt", "intnet",
                "train_intnet"):
        assert f"{port.__name__}.{mod}" in names


def test_kernel_sources_use_no_pytorch_headers():
    sources = glob.glob(os.path.join(PKG, "csrc", "*.cu*"))
    assert len(sources) >= 3
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "#include <torch" not in text and "ATen" not in text, path
    uses_builder = re.compile(r"import\s+cpp_extension|cpp_extension\s+import"
                              r"|cpp_extension\.load|import\s+torch\.utils"
                              r"\.cpp_extension")
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        with open(path) as f:
            assert not uses_builder.search(f.read()), path


def _fake_nvcc(directory):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "nvcc")
    with open(path, "w") as f:
        f.write("#!/bin/sh\nexit 1\n")
    os.chmod(path, 0o755)
    return path


def test_find_nvcc_order(tmp_path, monkeypatch):
    on_path = _fake_nvcc(str(tmp_path / "path"))
    in_home = _fake_nvcc(str(tmp_path / "cuda" / "bin"))
    monkeypatch.setenv("PATH", str(tmp_path / "path"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert _build.find_nvcc() == on_path
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert _build.find_nvcc() == in_home


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    """A compiler that fails: the build raises with its output and leaves
    no library (nor temporary file) that a later build would trust."""
    _fake_nvcc(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(_build, "_BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert glob.glob(str(tmp_path / "build" / "*" / "*")) == []


def test_host_coder_is_the_ports_own_build():
    """The host rANS coder compiles the port's own source with g++ into
    the port's build directory, and loads from there: never the JAX
    package's ``native/`` source or library."""
    jax_native = os.path.join(ROOT, "simple_image_compression_network_tpu",
                              "native")
    assert rans.SOURCE == os.path.join(PKG, "native", "rans.cpp")
    path, _ = rans.build()
    assert path.startswith(os.path.join(ROOT, "build", "torch_host") + os.sep)
    lib = rans.load_native()
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert not os.path.realpath(lib._name).startswith(jax_native)
    assert os.path.basename(_build.find_cxx()) == "g++"


def test_host_coder_build_uses_no_pytorch_header(tmp_path, monkeypatch):
    """The source includes no PyTorch header, and the g++ command names no
    PyTorch include directory."""
    with open(rans.SOURCE) as f:
        text = f.read()
    assert "#include <torch" not in text and "ATen" not in text
    assert "Python.h" not in text
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise subprocess.TimeoutExpired(cmd, 1)

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(rans, "_BUILD_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ exceeded"):
        rans.build()
    (cmd,) = calls
    assert os.path.basename(cmd[0]) == "g++"
    assert cmd[-1] == rans.SOURCE
    assert not any(a.startswith("-I") or "torch" in a for a in cmd[1:-1])
    assert glob.glob(str(tmp_path / "*" / "*")) == []
