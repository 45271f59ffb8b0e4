"""Kernel G's CPU side (``ops/cuda_deconv.py``): the plain four-phase form
of flax's ConvTranspose(5, 2, "SAME") against ``F.conv_transpose2d`` with
the SAME crop and against flax itself at g_s's (Cin, Cout) pairs (192 ->
128, 128 -> 128 twice, 128 -> 3), odd and even extents, B = 1 and 3; a
plain model of the kernel's reads of the packed weights; and the routing
of g_s's layers (float32 inference through the wrapper; h_s, training and
bf16 never).

Tolerance: a float32 sum of n terms in any order lies within gamma_n = n u
/ (1 - n u) of the sum of the terms' magnitudes (u = 2^-24; Higham's bound
for recursive summation), n = 9 Cin + 1 (the most taps an output phase
takes, and the bias).  Both sides are held to it against a float64 sum, so
any order passes and a wrong tap, weight or crop does not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from simple_image_compression_network_tpu_torch.models import hyperprior
from simple_image_compression_network_tpu_torch.ops import cuda_deconv
from simple_image_compression_network_tpu_torch.utils import weights_io

torch.set_num_threads(1)

U = 2.0 ** -24
PAIRS = [(192, 128), (128, 128), (128, 3)]   # g_s's (Cin, Cout) pairs
EXTENTS = {"even": (4, 6), "odd": (5, 3)}


def _case(seed: int, b: int, cin: int, cout: int, hw) -> tuple:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cin) + tuple(hw)).astype(np.float32)
    w = (rng.normal(size=(cin, cout, 5, 5)) / np.sqrt(25 * cin)).astype(
        np.float32)
    bias = rng.normal(scale=0.1, size=cout).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias)


def _golden(x, w, bias) -> tuple:
    """(float64 ConvTranspose(5, 2, SAME), the bound of a float32 sum)."""
    x64, w64 = x.double(), w.double()
    gold = F.conv_transpose2d(x64, w64, bias.double(), stride=2,
                              padding=1)[..., :-1, :-1]
    mag = F.conv_transpose2d(x64.abs(), w64.abs(), bias.double().abs(),
                             stride=2, padding=1)[..., :-1, :-1]
    n = 9 * x.shape[1] + 1
    return gold, n * U / (1 - n * U) * mag


def _assert_within(got: torch.Tensor, gold, tol) -> None:
    assert got.shape == gold.shape
    err = (got.double() - gold).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("extent", sorted(EXTENTS))
@pytest.mark.parametrize("cin,cout", PAIRS)
def test_plain_matches_conv_transpose2d_with_the_crop(cin, cout, extent, b):
    """The four phase convs against PyTorch's transposed conv (padding 1,
    last row and column dropped): output exactly 2H x 2W, both within a
    float32 sum's bound of the float64 golden."""
    x, w, bias = _case(cin + cout + b, b, cin, cout, EXTENTS[extent])
    got = cuda_deconv.deconv5s2_f32_plain(x, w, bias)
    torch_out = F.conv_transpose2d(x, w, bias, stride=2,
                                   padding=1)[..., :-1, :-1]
    gold, tol = _golden(x, w, bias)
    assert got.shape == (b, cout, 2 * x.shape[2], 2 * x.shape[3])
    _assert_within(got, gold, tol)
    _assert_within(torch_out, gold, tol)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("extent", sorted(EXTENTS))
@pytest.mark.parametrize("cin,cout", PAIRS)
def test_plain_matches_flax_conv_transpose(cin, cout, extent, b):
    """Against flax's ConvTranspose(5, 2, "SAME"), as the JAX package's
    g_s builds it, on the same kernel (flax (kh, kw, in, out), mapped to
    the port's layout by ``weights_io``)."""
    rng = np.random.default_rng(7 * cin + cout + b)
    hw = EXTENTS[extent]
    x = rng.normal(size=(b,) + hw + (cin,)).astype(np.float32)     # NHWC
    kernel = (rng.normal(size=(5, 5, cin, cout))
              / np.sqrt(25 * cin)).astype(np.float32)
    bias = rng.normal(scale=0.1, size=cout).astype(np.float32)
    want = np.array(nn.ConvTranspose(cout, (5, 5), strides=(2, 2),
                                       padding="SAME").apply(
        {"params": {"kernel": jnp.asarray(kernel),
                    "bias": jnp.asarray(bias)}}, jnp.asarray(x)))
    w = weights_io._leaf_to_torch("g_s.ConvTranspose_0", "kernel", kernel)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = cuda_deconv.deconv5s2_f32_plain(xt, w, torch.from_numpy(bias))
    gold, tol = _golden(xt, w, torch.from_numpy(bias))
    _assert_within(got, gold, tol)
    _assert_within(torch.from_numpy(want).permute(0, 3, 1, 2), gold, tol)


def _kernel_model(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                  o: int, variant: int) -> torch.Tensor:
    """Kernel G's arithmetic in float64, reading the packed weights as the
    kernel does: output channel o' of block ob, group g, lane n takes
    column g*TNP + n of row (c, ky*5 + kx); tap (dy, dx) = (a - 1, bx - 1)
    adds to phase (py, px) with ky = py + 3 - 2a, kx = px + 3 - 2bx."""
    v = cuda_deconv.VARIANTS[variant]
    b, c, h, wd = x.shape
    xp = F.pad(x.double(), (1, 1, 1, 1))
    out = torch.zeros((b, o, 2 * h, 2 * wd), dtype=torch.float64)
    for oo in range(o):
        ob, rem = divmod(oo, v.ng * v.tn)
        g, n = divmod(rem, v.tn)
        col = wp[ob, :c, :, g * v.tnp + n].double()          # (c, 25)
        for py in range(2):
            for px in range(2):
                acc = torch.zeros((b, h, wd), dtype=torch.float64)
                for a in range(3):
                    for bx in range(3):
                        ky, kx = py + 3 - 2 * a, px + 3 - 2 * bx
                        if 0 <= ky <= 4 and 0 <= kx <= 4:
                            acc += torch.einsum(
                                "bchw,c->bhw",
                                xp[:, :, a:a + h, bx:bx + wd],
                                col[:, ky * 5 + kx])
                out[:, oo, py::2, px::2] = acc + float(bias[oo])
    return out


@pytest.mark.parametrize("variant,cin,cout", [
    (cuda_deconv.MAIN, 6, 37), (cuda_deconv.MAIN, 20, 32),
    (cuda_deconv.RGB, 9, 3), (cuda_deconv.RGB, 4, 1)])
def test_packed_weights_read_as_the_kernel_reads_them(variant, cin, cout):
    """C off the stage's KC and O off the block's channels (zero rows and
    columns), the RGB tile's 4th column: the kernel's reads of the packed
    layout give the transposed conv, and the padding holds zeros."""
    x, w, bias = _case(cin * cout, 2, cin, cout, (3, 5))
    wp = cuda_deconv.pack_deconv5s2(w, variant)
    v = cuda_deconv.VARIANTS[variant]
    n_ob = -(-cout // (v.ng * v.tn))
    assert tuple(wp.shape) == (n_ob, -(-cin // v.kc) * v.kc, 25,
                               v.ng * v.tnp)
    assert wp.is_contiguous()
    assert float(wp.abs().sum()) == pytest.approx(float(w.abs().sum()),
                                                  rel=1e-6)
    gold, tol = _golden(x, w, bias)
    _assert_within(_kernel_model(x, wp, bias, cout, variant), gold, tol)


def test_pick_variant():
    assert cuda_deconv.pick_variant(3) == cuda_deconv.RGB
    assert cuda_deconv.pick_variant(1) == cuda_deconv.RGB
    assert cuda_deconv.pick_variant(128) == cuda_deconv.MAIN
    assert cuda_deconv.pick_variant(4) == cuda_deconv.MAIN


def test_wrapper_checks_its_inputs():
    x, w, bias = _case(0, 1, 4, 5, (3, 3))
    with pytest.raises(TypeError):
        cuda_deconv.deconv5s2_f32(x.to(torch.bfloat16), w, bias)
    with pytest.raises(ValueError):
        cuda_deconv.deconv5s2_f32(x, w[:3], bias)
    with pytest.raises(ValueError):
        cuda_deconv.deconv5s2_f32(x, w, bias[:4])
    with pytest.raises(ValueError):
        cuda_deconv.deconv5s2_f32(x[0], w, bias)


def _model(dtype=torch.float32):
    model = hyperprior.ScaleHyperprior(n=8, m=12, device="cpu", dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(4))
    return model


def _plain_runs(fn) -> int:
    before = cuda_deconv.deconv5s2_f32.plain_runs
    fn()
    return cuda_deconv.deconv5s2_f32.plain_runs - before


def test_g_s_float32_inference_goes_through_the_wrapper():
    """g_s's four layers keep ``_Deconv``'s type and names and run the
    wrapper (its plain version on the CPU) in float32 with no gradient to
    take: under no_grad, in ``decode_arrays``, and in grad mode on a frozen
    model; the result is the transposed conv's."""
    model = _model()
    names = [k for k in model.state_dict() if k.startswith("g_s.ConvT")]
    assert names == [f"g_s.ConvTranspose_{i}.{p}" for i in range(4)
                     for p in ("weight", "bias")]
    for i in range(4):
        assert isinstance(getattr(model.g_s, f"ConvTranspose_{i}"),
                          hyperprior._Deconv)
    y = torch.randn((2, 12, 3, 5), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        assert _plain_runs(lambda: model.g_s(y)) == 4
    assert _plain_runs(lambda: model.decode_arrays(
        y.permute(0, 2, 3, 1))) == 4
    assert _plain_runs(lambda: model.g_s(y)) == 4      # frozen, grad mode
    layer = model.g_s.ConvTranspose_0
    with torch.no_grad():
        got = layer(y)
        want = F.conv_transpose2d(y, layer.weight, layer.bias, stride=2,
                                  padding=1)[..., :-1, :-1]
    gold, tol = _golden(y, layer.weight, layer.bias)
    _assert_within(got, gold, tol)
    _assert_within(want, gold, tol)


def test_h_s_training_and_bf16_never_call_the_wrapper():
    """h_s keeps ``_Deconv`` itself (deterministic cuDNN on the card: its
    scales must be the same bits at both ends); a g_s whose parameters
    require grad, or whose input does, in grad mode, and a bf16 g_s, take
    ``_Deconv``'s path."""
    model = _model()
    for i in range(2):
        assert type(getattr(model.h_s, f"ConvTranspose_{i}")) is \
            hyperprior._Deconv
    z = torch.randn((1, 2, 2, 8), generator=torch.Generator().manual_seed(6))
    assert _plain_runs(lambda: model.scales_from_z(z)) == 0
    y = torch.randn((1, 12, 2, 3), generator=torch.Generator().manual_seed(7))
    model.requires_grad_(True)
    out = {}

    def train_step():
        out["x"] = model.g_s(y)
        out["x"].sum().backward()
    assert _plain_runs(train_step) == 0
    assert model.g_s.ConvTranspose_0.weight.grad is not None
    model.requires_grad_(False)
    assert _plain_runs(lambda: model.g_s(y.clone().requires_grad_(True))) \
        == 0
    bf16 = _model(torch.bfloat16)
    with torch.no_grad():
        assert _plain_runs(lambda: bf16.g_s(y)) == 0
