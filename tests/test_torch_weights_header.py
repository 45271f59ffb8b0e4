"""The port's header loaders (``utils/weights_io.py``:
``parse_memdata_header``, ``fold_to_dense``, ``load_reference_params``,
``save_checkpoint``) against the JAX package's.

The reference header (``memdata_nonsquare.h``) is not in this tree, so the
test writes one: ``checkpoints/reference_weights.npz`` packed in the fold
layout of ``config.py``'s PE / SIMD / TILES (the inverse of the testbench's
unpack order), SIMD fields little-endian in ``ap_uint<SIMD*WBIT>`` hex
words, the biases as ``FixedPointWeights<1, ap_int<8>, 1, OFM_CH>``.  Both
parsers must give back the npz exactly (integers: no tolerance)."""

import os

import numpy as np
import pytest

from simple_image_compression_network_tpu.utils import weights_io as j_wio
from simple_image_compression_network_tpu_torch.config import (
    REFERENCE_NET, reference_net_for_input)
from simple_image_compression_network_tpu_torch.utils import weights_io

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NPZ = os.path.join(ROOT, "checkpoints", "reference_weights.npz")


def dense_to_fold(dense: np.ndarray, pe_n: int, simd: int) -> np.ndarray:
    """[O, kx, ky, I] -> (PE, TILES, SIMD): per pe the stream [out-block]
    [ky][kx][in-channel], out channel pe + PE * block."""
    per_pe = np.stack([dense[pe::pe_n].transpose(0, 2, 1, 3)
                       for pe in range(pe_n)])
    return per_pe.reshape(pe_n, -1, simd).astype(np.int64)


def pack_words(fields: np.ndarray, wbit: int) -> list:
    """(..., SIMD) signed fields -> ap_uint<SIMD*WBIT> words (Python ints,
    field i in bits [i*WBIT, (i+1)*WBIT))."""
    mask = (1 << wbit) - 1
    flat = fields.reshape(-1, fields.shape[-1])
    return [sum((int(v) & mask) << (i * wbit) for i, v in enumerate(row))
            for row in flat]


def declaration(name: str, simd: int, wbit: int, pe: int, tiles: int,
                words) -> str:
    rows = []
    for p in range(pe):
        chunk = words[p * tiles:(p + 1) * tiles]
        rows.append("{" + ",".join(hex(w) for w in chunk) + "}")
    return (f"static FixedPointWeights<{simd}, ap_int<{wbit}>, {pe}, "
            f"{tiles}> {name} = {{{{\n" + ",\n".join(rows) + "\n}};\n")


def write_header(path: str, params: dict, cfg) -> None:
    parts = ['#include "weights.hpp"\n']
    for i, layer in enumerate(cfg.layers):
        w = params[f"w{i}"]
        parts.append(declaration(
            f"weights_layer{i}", layer.simd, layer.w_bits, layer.pe,
            layer.w_tiles,
            pack_words(dense_to_fold(w, layer.pe, layer.simd),
                       layer.w_bits)))
        parts.append(declaration(
            f"bias_layer{i}", 1, 8, 1, layer.out_ch,
            pack_words(params[f"b{i}"].astype(np.int64)[:, None], 8)))
    with open(path, "w") as f:
        f.write("".join(parts))


@pytest.fixture(scope="module")
def header(tmp_path_factory):
    params = weights_io.load_checkpoint(NPZ)
    path = str(tmp_path_factory.mktemp("hdr") / "memdata_nonsquare.h")
    write_header(path, params, REFERENCE_NET)
    return path, params


def test_reference_header_round_trip_equals_the_npz_and_jax(header):
    path, want = header
    got = weights_io.load_reference_params(path)
    ref = j_wio.load_reference_params(path)
    assert sorted(got) == sorted(want) == sorted(ref)
    for k, v in want.items():
        assert got[k].dtype == ref[k].dtype == np.int8, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_parse_memdata_header_equals_jax(header):
    path, _ = header
    got, ref = (weights_io.parse_memdata_header(path),
                j_wio.parse_memdata_header(path))
    assert sorted(got) == sorted(ref) and len(got) == 16
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_parse_refuses_a_short_declaration(tmp_path):
    path = tmp_path / "short.h"
    path.write_text(declaration("weights_layer0", 3, 4, 2, 3,
                                [1, 2, 3, 4, 5]))
    for parse in (weights_io.parse_memdata_header,
                  j_wio.parse_memdata_header):
        with pytest.raises(ValueError, match="expected PE\\*TILES=6"):
            parse(str(path))


@pytest.mark.parametrize("simd,wbit", [(3, 4), (8, 4), (12, 4), (1, 8)])
def test_unpack_words_sign_extends_as_jax(simd, wbit):
    rng = np.random.default_rng(simd * 10 + wbit)
    words = rng.integers(0, 1 << min(simd * wbit, 62), size=(4, 7),
                         dtype=np.int64)
    got = weights_io._unpack_words(words, simd, wbit)
    np.testing.assert_array_equal(got, j_wio._unpack_words(words, simd,
                                                           wbit))
    lo, hi = -(1 << (wbit - 1)), (1 << (wbit - 1)) - 1
    assert got.min() >= lo and got.max() <= hi


def test_fold_to_dense_is_the_inverse_of_the_packing():
    rng = np.random.default_rng(5)
    for (pe_n, simd, o, i) in [(4, 3, 8, 6), (3, 8, 3, 128), (16, 8, 128, 8)]:
        dense = rng.integers(-8, 8, size=(o, 5, 5, i)).astype(np.int8)
        folded = dense_to_fold(dense, pe_n, simd)
        got = weights_io.fold_to_dense(folded, o, i, 5)
        np.testing.assert_array_equal(got, dense)
        np.testing.assert_array_equal(got, j_wio.fold_to_dense(folded, o,
                                                               i, 5))


def test_load_reference_params_of_a_smaller_geometry(tmp_path):
    """The folding factors do not depend on the input size: a header of
    the 64x64 net loads as the full one does."""
    cfg = reference_net_for_input(64, 64)
    rng = np.random.default_rng(2)
    params = {}
    for i, layer in enumerate(cfg.layers):
        params[f"w{i}"] = rng.integers(-8, 8, size=layer.weight_shape
                                       ).astype(np.int8)
        params[f"b{i}"] = rng.integers(-128, 128, size=(layer.out_ch,)
                                       ).astype(np.int8)
    path = str(tmp_path / "small.h")
    write_header(path, params, cfg)
    got = weights_io.load_reference_params(path, cfg)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_save_checkpoint_round_trips_both_ways(tmp_path, header):
    _, params = header
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    weights_io.save_checkpoint(a, params)
    j_wio.save_checkpoint(b, params)
    for path in (a, b):
        for load in (weights_io.load_checkpoint, j_wio.load_checkpoint):
            got = load(path)
            assert sorted(got) == sorted(params)
            for k, v in params.items():
                np.testing.assert_array_equal(got[k], v)
                assert got[k].dtype == v.dtype
