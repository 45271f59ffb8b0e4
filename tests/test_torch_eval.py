"""The port's evaluation harness (``eval_codec.py``) and its images
(``utils/data.py``) against the JAX package's: the synthetic images byte
for byte, and ``main`` on a folder of two 64x64 PNG images, whose bit-exact
codecs (int8, wavelet) print the JAX package's bpp and PSNR to the last
digit and whose mean-scale codec prints its bpp exactly and its PSNR within
0.01 dB (the float transforms of two frameworks)."""

import os
import sys

import numpy as np
import pytest
import torch

from simple_image_compression_network_tpu import eval_codec as j_eval
from simple_image_compression_network_tpu.utils import data as j_data
from simple_image_compression_network_tpu_torch import eval_codec
from simple_image_compression_network_tpu_torch.utils import data

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "hp_meanscale_l0.01.params.msgpack")


@pytest.mark.parametrize("n,x,y,seed", [(4, 768, 512, 0), (2, 64, 96, 3)])
def test_synthetic_images_match_jax(n, x, y, seed):
    got = data.synthetic_images(n, x, y, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (n, x, y, 3)
    np.testing.assert_array_equal(got, j_data.synthetic_images(n, x, y,
                                                               seed=seed))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two 64x64 PNG images (and a file that is not one)."""
    from PIL import Image
    d = tmp_path_factory.mktemp("images")
    for i, img in enumerate(data.synthetic_images(2, 64, 64, seed=5)):
        Image.fromarray(img).save(d / f"im{i}.png")
    (d / "notes.txt").write_text("not an image")
    return d


def test_folder_images_match_jax(folder):
    paths = data.list_images(str(folder))
    assert paths == j_data.list_images(str(folder)) and len(paths) == 2
    for p in paths:
        np.testing.assert_array_equal(data.load_image(p),
                                      j_data.load_image(p))


@pytest.mark.parametrize("argv,psnr_tol", [
    (["--codec", "int8"], 0.0),
    (["--codec", "wavelet", "--profile", "haar420"], 0.0),
    (["--codec", "meanscale", "--ckpt", CKPT], 0.01)],
    ids=["int8", "wavelet-haar420", "meanscale"])
def test_main_matches_jax(folder, capsys, argv, psnr_tol):
    argv = ["--data", str(folder)] + argv
    want = j_eval.main(argv)
    capsys.readouterr()
    got = eval_codec.main(argv + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("{") and '"n_images": 2' in line
    assert got["bpp"] == want["bpp"]
    assert [r["bpp"] for r in got["per_image"]] == [
        r["bpp"] for r in want["per_image"]]
    if psnr_tol:
        assert abs(got["psnr"] - want["psnr"]) <= psnr_tol
    else:
        assert got["psnr"] == want["psnr"]


def test_hyper_codecs_need_a_released_checkpoint():
    """The hyper codecs need --ckpt; a training checkpoint is read as one
    (utils/train_ckpt.py; served in tests/test_torch_train_ckpt.py), so a
    missing one raises as a missing file, not as unported."""
    with pytest.raises(ValueError, match="--ckpt"):
        eval_codec.main(["--codec", "meanscale", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="ckpt_1000"):
        eval_codec.main(["--codec", "hyperprior", "--device", "cpu",
                         "--ckpt", "runs/hp01/ckpt_1000.msgpack"])


def test_load_image_names_data_without_pil(folder, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="--data"):
        data.load_image(str(folder / "im0.png"))
