"""The yardstick's operation counts against the configurations' shapes."""

import pytest

from simple_image_compression_network_tpu_torch.config import REFERENCE_NET
from sicbench import harness

INT8 = harness.Cell("int8_ref.bulk_b32").work
HYPER = harness.Cell("hyper_scale.bulk_b8").work


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_int8_direction_is_14_47_gmac(direction):
    assert INT8.macs(direction, 768, 512) == 14_470_348_800


def test_transposed_convs_count_input_positions():
    analysis = sum(l.macs for l in REFERENCE_NET.analysis)
    synthesis = sum(l.macs for l in REFERENCE_NET.synthesis)
    assert INT8.macs("encode", 768, 512) == analysis
    # LayerConfig.macs counts the deconvs over their output positions,
    # zeros included: four times the work the model needs
    assert synthesis == 4 * INT8.macs("decode", 768, 512)


def test_hyper_stages():
    s = HYPER._stages(768, 512)
    assert s["g"] == 14_470_348_800
    assert abs(s["gdn"] / 1e9 - 2.11) < 0.01
    assert abs(s["h_a"] / 1e9 - 0.54) < 0.01
    assert s["h_s"] == s["h_a"]
    assert abs(HYPER.macs("encode", 768, 512) / 1e9 - 17.66) < 0.01
    assert abs(HYPER.macs("decode", 768, 512) / 1e9 - 17.12) < 0.01
    assert HYPER.ops("decode", 768, 512) == 2 * HYPER.macs("decode", 768,
                                                           512)
