"""FP formats of the PyTorch port against the JAX reference, bit for bit:
``cast_to_fp`` (e4m3, e2m1 and the other table formats), the fp8 and NVFP4
packings (codes, e4m3 scale bytes, ``scale2``) and their dequantizers in
both directions, ``fake_quant_fp`` and NVFP4's two-level block fake-quant;
then the presets, ``compressible_format`` and a dense model quantized and
calibrated under NVFP4 and FP8 in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.core.bundle import ModelBundle
from modelopt_tpu.core.tree import flatten_with_paths, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant import api as japi
from modelopt_tpu.quant import fake_quant as jfq
from modelopt_tpu.quant import formats as jf
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
from modelopt_tpu_torch.core.bundle import ModelBundle as TBundle
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.quant import api as tapi
from modelopt_tpu_torch.quant import fake_quant as tfq
from modelopt_tpu_torch.quant import formats as tf
from modelopt_tpu_torch.quant import qtensor as tq
from modelopt_tpu_torch.quant.config import get_config as tget_config
from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    """The raw bytes of an array (e4m3 and f32 alike), for bit-for-bit
    comparison."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _tbits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy().view(np.uint8 if t.element_size() == 1 else np.uint32)


def _j2t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _probe(rng, n=4096):
    """Values at every scale the formats meet: normals across 2^-30..2^12,
    the f32 subnormal range, exact zeros of both signs, grid midpoints
    (ties) and values past the formats' largest finite values."""
    mag = np.exp2(rng.uniform(-30, 12, n)).astype(np.float32)
    x = mag * rng.choice([-1.0, 1.0], n).astype(np.float32)
    ties = (np.arange(-64, 65) * 0.25).astype(np.float32)  # e2m1 midpoints included
    specials = np.array([0.0, -0.0, 1e-40, -1e-40, 448.0, 464.0, 500.0, -1e6, 6.0, 5.0,
                         7.0, 2.0**-9, 2.0**-10, 3 * 2.0**-10], np.float32)
    return np.concatenate([x, ties, specials])


@pytest.mark.parametrize("fmt", [(4, 3), (2, 1), (5, 2), (3, 2), (2, 3)])
def test_cast_to_fp_bit_exact(rng, fmt):
    x = _probe(rng)
    want = np.asarray(jf.cast_to_fp(jnp.asarray(x), jf.get_format(*fmt)))
    got = tf.cast_to_fp(torch.from_numpy(x), tf.get_format(*fmt)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if fmt == (4, 3):
        # cast_to_fp's e4m3 branch is torch's float8_e4m3fn round trip of the
        # clipped values: the same grid (zeros compare equal whatever sign)
        xc = np.clip(x, -448.0, 448.0)
        native = torch.from_numpy(xc).to(torch.float8_e4m3fn).float().numpy()
        np.testing.assert_array_equal(native, np.clip(want, -448.0, 448.0))


def test_format_table_and_parse():
    for name in ("e4m3", "e2m1", "e5m2", "e8m0", "e3m3"):
        a, b = jf.parse_format(name), tf.parse_format(name)
        assert (a.exp_bits, a.man_bits, a.maxval) == (b.exp_bits, b.man_bits, b.maxval)
        assert (a.bias, a.emax, a.min_normal_exp) == (b.bias, b.emax, b.min_normal_exp)
    assert tf.parse_format((4, 3)) is tf.get_format(4, 3)
    assert TSpec(num_bits=(2, 1)).maxval == 6.0 and TSpec(num_bits=8).maxval == 127.0
    e = np.arange(-126, 128, dtype=np.int32)
    np.testing.assert_array_equal(tf.exp2_int(torch.from_numpy(e)).numpy(),
                                  np.asarray(jf.exp2_int(jnp.asarray(e))))
    x = np.exp2(np.arange(-120, 120, 0.37)).astype(np.float32)
    np.testing.assert_array_equal(tf.floor_log2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jf.floor_log2(jnp.asarray(x))))
    with pytest.raises(ValueError):
        tf.parse_format("int8")
    with pytest.raises(NotImplementedError, match="e8m0"):
        tf.cast_to_fp(torch.ones(2), tf.get_format(8, 0))


@pytest.mark.parametrize("K,N,scale", [(64, 48, 1.0), (256, 128, 0.02), (32, 16, 3e4)])
def test_quantize_fp8_bit_exact(rng, K, N, scale):
    w = (rng.standard_normal((K, N)) * scale).astype(np.float32)
    w[0, 0] = 0.0
    pj = jq.quantize_fp8(jnp.asarray(w))
    pt = tq.quantize_fp8(torch.from_numpy(w))
    assert pt["data"].dtype == torch.float8_e4m3fn and pt["scale"].shape == (1, 1)
    np.testing.assert_array_equal(_tbits(pt["data"]), _bits(pj["data"]))
    np.testing.assert_array_equal(_tbits(pt["scale"]), _bits(pj["scale"]))
    # each package dequantizes the other's bytes identically
    np.testing.assert_array_equal(
        tq.dequantize_fp8({k: _j2t(v) for k, v in pj.items()}).numpy(),
        np.asarray(jq.dequantize_fp8(pj)))


@pytest.mark.parametrize("K,N,block", [(64, 32, 16), (384, 128, 16), (96, 8, 16)])
def test_quantize_nvfp4_bit_exact(rng, K, N, block):
    """Codes, e4m3 block-scale bytes and scale2 equal; blocks of very
    different ranges (scales near the e4m3 subnormals) and all-zero blocks
    included."""
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:block] *= 1e-4
    w[block:2 * block, : N // 2] = 0.0
    w[-block:] *= 50.0
    pj = jq.quantize_nvfp4(jnp.asarray(w), block)
    pt = tq.quantize_nvfp4(torch.from_numpy(w), block)
    assert pt["data"].dtype == torch.uint8 and pt["scale"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(pt["data"].numpy(), np.asarray(pj["data"]))
    np.testing.assert_array_equal(_tbits(pt["scale"]), _bits(pj["scale"]))
    np.testing.assert_array_equal(_tbits(pt["scale2"]), _bits(pj["scale2"]))
    want = np.asarray(jq.dequantize_nvfp4(pj, block))
    np.testing.assert_array_equal(
        _bits(tq.dequantize_nvfp4({k: _j2t(v) for k, v in pj.items()}, block).numpy()),
        _bits(want))
    np.testing.assert_array_equal(
        _bits(np.asarray(jq.dequantize_nvfp4({k: jnp.asarray(_t2np(v)) for k, v in pt.items()},
                                             block))),
        _bits(want))


def _t2np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the reference's numpy array (e4m3 through ml_dtypes)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return t.numpy()


def test_e2m1_codes_bit_exact():
    """Every e2m1 midpoint and grid value encodes as the reference encodes
    it (exact midpoints round to the smaller magnitude), and decodes back."""
    x = np.concatenate([np.arange(-6.0, 6.01, 0.125), [-0.0, 0.25, 0.75, 5.0, -5.0]])
    x = x.astype(np.float32)
    cj = np.asarray(jq._encode_e2m1(jnp.asarray(x)))
    ct = tq._encode_e2m1(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ct, cj)
    codes = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(
        _bits(tq._decode_e2m1(torch.from_numpy(codes)).numpy()),
        _bits(np.asarray(jq._decode_e2m1(jnp.asarray(codes)))))


@pytest.mark.parametrize("amax", [1.0, 37.5, 1e-3])
@pytest.mark.parametrize("fmt", [(4, 3), (2, 1)])
def test_fake_quant_fp_bit_exact(rng, amax, fmt):
    x = (rng.standard_normal((8, 64)) * amax).astype(np.float32)
    want = np.asarray(jfq.fake_quant_fp(jnp.asarray(x), jnp.float32(amax), jf.get_format(*fmt)))
    got = tfq.fake_quant_fp(torch.from_numpy(x), torch.tensor(amax), tf.get_format(*fmt))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the fp spec's dispatch: a calibrated amax, and dynamic (from x)
    js, ts = JSpec(num_bits=fmt), TSpec(num_bits=fmt)
    np.testing.assert_array_equal(
        _bits(tfq.fake_quantize(torch.from_numpy(x), ts).numpy()),
        _bits(np.asarray(jfq.fake_quantize(jnp.asarray(x), js))))


NVFP4_BLOCK = {-2: 16, "type": "dynamic", "scale_format": "e4m3", "two_level": True}


@pytest.mark.parametrize("shape,block,tensor_amax", [
    ((64, 48), NVFP4_BLOCK, None),
    ((40, 24), NVFP4_BLOCK, 9.0),  # 40 rows: the last block zero-padded
    ((4, 6, 64), {-1: 16, "type": "dynamic", "scale_format": "e4m3", "two_level": True},
     None),
])
def test_nvfp4_block_fake_quant_bit_exact(rng, shape, block, tensor_amax):
    """NVFP4 two-level block fake quantization (weights along -2,
    activations along -1), per-tensor amax from x or calibrated."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., :3] *= 40.0
    js = JSpec(num_bits=(2, 1), block=block)
    ts = TSpec(num_bits=(2, 1), block=block)
    ta_j = None if tensor_amax is None else jnp.float32(tensor_amax)
    ta_t = None if tensor_amax is None else torch.tensor(tensor_amax)
    want = np.asarray(jfq.fake_quantize(jnp.asarray(x), js, tensor_amax=ta_j))
    got = tfq.fake_quantize(torch.from_numpy(x), ts, tensor_amax=ta_t).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the two-level scales alone
    bam = np.abs(x.reshape(-1, 16)).max(axis=1, keepdims=True)
    fmt_j, fmt_t = jf.get_format(4, 3), tf.get_format(4, 3)
    np.testing.assert_array_equal(
        _bits(tfq._block_scales_two_level(torch.from_numpy(bam), 6.0, fmt_t,
                                          torch.tensor(7.5)).numpy()),
        _bits(np.asarray(jfq._block_scales_two_level(jnp.asarray(bam), 6.0, fmt_j,
                                                     jnp.float32(7.5)))))


def test_unported_fp_specs_raise():
    x = torch.randn(4, 32)
    for spec in (TSpec(num_bits=(4, 3), axis=(-1,)),
                 TSpec(num_bits=(2, 1), block={-1: 32, "type": "dynamic",
                                              "scale_format": "e8m0"}),
                 TSpec(num_bits=(2, 1), block=dict(NVFP4_BLOCK, four_over_six=True))):
        with pytest.raises(NotImplementedError):
            tfq.fake_quantize(x, spec)


PRESETS = ["INT8_WEIGHT_ONLY_CFG", "FP8_DEFAULT_CFG", "FP8_WEIGHT_ONLY_CFG",
           "NVFP4_WEIGHT_ONLY_CFG", "W4A16_NVFP4_CFG"]
PATHS = ["layers_0/attn/qkv_proj/weight_quantizer", "layers_0/attn/qkv_proj/input_quantizer",
         "layers_1/mlp/experts/wo/weight_quantizer", "lm_head/weight_quantizer",
         "layers_0/attn/k_quantizer", "layers_0/mlp/router/weight_quantizer"]


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_resolve_as_reference(preset):
    """Each new preset resolves every path to the reference's specs, and
    ``compressible_format`` names the reference's packed format for each
    weight shape (None where the port packs nothing yet: the reference's
    mxfp formats)."""
    jc, tc = jget_config(preset), tget_config(preset)
    for path in PATHS:
        js, ts = jc.resolve(path), tc.resolve(path)
        assert (js is None) == (ts is None), path
        if js is not None:
            assert [dataclasses.asdict(s) for s in js] == [dataclasses.asdict(s) for s in ts]
            for shape in ((64, 32), (96, 32), (40, 8), (64, 16, 8)):
                assert tq.compressible_format(ts[0], shape) == \
                    jq.compressible_format(js[0], shape), (path, shape)


# --------------------------------------------------------------------------
# a dense model quantized and calibrated in both packages
# --------------------------------------------------------------------------
def _dense_pair(preset, seed=0):
    """A tiny llama (f32) with numpy-drawn weights, quantized under
    ``preset`` with one max-calibration batch in the reference and in the
    port; returns both bundles and a batch of ids."""
    rng = np.random.default_rng(seed)
    tcfg = tt.tiny_test_config(dtype=torch.float32, hidden_size=64, intermediate_size=96)
    names = [f.name for f in dataclasses.fields(tcfg) if f.name not in ("dtype", "param_dtype")]
    module = jt.Decoder(jt.DecoderConfig(dtype=jnp.float32,
                                         **{n: getattr(tcfg, n) for n in names}))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel":
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        elif keys[-1] == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            arr = rng.standard_normal(leaf.shape)
        params = set_in(params, keys, jnp.asarray(arr, jnp.float32))
    batch = rng.integers(1, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jb = ModelBundle(module=module, variables={"params": params}, example_inputs=(ids,))
    jb = japi.quantize(jb, preset, forward_loop=lambda f: f(jnp.asarray(batch)))
    tb = from_jax_variables({"params": jax.tree.map(np.asarray, params)}, tcfg, device="cpu")
    tb = tapi.quantize(TBundle(module=tb.module, records=()), preset,
                       forward_loop=lambda f: f(torch.from_numpy(batch)))
    return jb, tb, batch


@pytest.mark.parametrize("preset", ["NVFP4_WEIGHT_ONLY_CFG", "FP8_DEFAULT_CFG"])
def test_quantize_dense_model_matches_reference(preset):
    """``quantize`` with max calibration: the same quantizers hold an amax;
    a weight's (NVFP4's per-tensor amax, FP8's) is bit-equal to the
    reference's, an activation's within f32 rounding (the layers before it
    sum in another order); the fake-quantized logits within f32 rounding."""
    jb, tb, batch = _dense_pair(preset)
    jamax = {p.rsplit("/", 1)[0]: np.asarray(v) for p, v in
             flatten_with_paths(jb.variables["quant"]) if p.endswith("/amax")}
    tamax = {m.path: m.amax.numpy() for m in tb.module.modules()
             if getattr(m, "amax", None) is not None}
    assert sorted(jamax) == sorted(tamax) and jamax
    for k in jamax:
        got = tamax[k].reshape(jamax[k].shape)
        if k.endswith("weight_quantizer"):
            np.testing.assert_array_equal(_bits(got), _bits(jamax[k]))
        else:
            np.testing.assert_allclose(got, jamax[k], rtol=1e-5)
    want = np.asarray(jb.apply(jnp.asarray(batch))[0])
    got, _ = tb.apply(torch.from_numpy(batch))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
