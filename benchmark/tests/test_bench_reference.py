"""The plain reference against the program's host path at small sizes:
it reads the program's containers, and its transforms and tables equal
the program's goldens."""

import numpy as np
import pytest
import torch

from conftest import ROOT
from sicbench import harness
from simple_image_compression_network_tpu_torch.codec import int_codec
from simple_image_compression_network_tpu_torch.models import codec_int


@pytest.fixture(scope="module")
def int8():
    cell = harness.Cell("int8_ref.bulk_b32")
    return cell, cell.reference("cpu"), cell.work.Codec(cell.cfg, ROOT,
                                                        "cpu")


def test_int8_transforms_equal_the_golden_on_random_weights(int8):
    _, ref, _ = int8
    params = codec_int.random_params(seed=3)
    ref.w = [params[f"w{i}"].to(torch.float32).permute(0, 3, 1, 2)
             .contiguous() for i in range(8)]
    ref.b = [params[f"b{i}"].to(torch.int64) for i in range(8)]
    try:
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (2, 64, 48, 3), dtype=np.uint8))
        z = codec_int.analysis_int8(params, x, impl=codec_int.GOLDEN_PLAN)
        assert torch.equal(ref.analysis(x), z.to(torch.int64))
        xh = codec_int.synthesis_int8(params, z, impl=codec_int.GOLDEN_PLAN)
        assert torch.equal(ref.synthesis(z), xh.to(torch.int64))
    finally:
        fresh = harness.Cell("int8_ref.bulk_b32").reference("cpu")
        ref.w, ref.b = fresh.w, fresh.b


def test_int8_reference_reads_the_programs_containers(int8):
    _, ref, codec = int8
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, 64, 96, 3), dtype=np.uint8))
    blobs = int_codec.compress_batch(codec.net, x, codec.cdfs)
    x_hat, _ = int_codec.decompress_batch(codec.net, blobs, codec.cdfs)
    got = ref.judge(blobs, x=x, x_hat=x_hat)
    assert got == {"streams_rejected": 0, "z_mismatch": 0, "x_mismatch": 0}
    bad = bytearray(blobs[1])
    bad[-5] ^= 0x5A
    got = ref.judge([blobs[0], bytes(bad), blobs[2]], x=x, x_hat=x_hat)
    assert got["streams_rejected"] + got["z_mismatch"] > 0


@pytest.fixture(scope="module")
def hyper():
    cell = harness.Cell("hyper_scale.bulk_b8")
    return cell.reference("cpu"), cell.work.Codec(cell.cfg, ROOT, "cpu")


def test_hyper_tables_equal_the_programs(hyper):
    ref, codec = hyper
    assert np.array_equal(ref.z_cdfs.numpy(), codec.codec.z_cdfs)
    assert np.array_equal(ref.y_cdfs.numpy(), codec.codec.y_cdfs_dev)


def test_hyper_reference_reads_the_programs_containers(hyper):
    ref, codec = hyper
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(4))
    blobs = codec.codec.compress_batch(x)
    x_hat, y_hat = codec.codec.decompress_batch(blobs)
    got = ref.judge(blobs, codec.sigma_of, x=x, x_hat=x_hat, y_hat=y_hat)
    assert got["streams_rejected"] == 0 and got["y_hat_mismatch"] == 0
    for k in ("z_gap", "y_gap", "x_gap"):
        assert got[k] < 1e-4, (k, got)
    assert got["log_sigma_gap"] < 1e-4
