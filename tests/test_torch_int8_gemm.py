"""The INT8 W8A8 pieces of the port against the JAX package:
``int8_dynamic_gemm`` (dynamic per-row int8 activations times per-channel
int8 weights) bit for bit, ``qgemm``'s route to it, and per-channel int8
amax calibration and fake quantization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.nn.quantizer import _broadcast_amax, _stat_shape_and_value
from modelopt_tpu.quant import backends as jb
from modelopt_tpu.quant import fake_quant as jfq
from modelopt_tpu.quant import qtensor as jq
from modelopt_tpu.quant.qspec import QuantizerSpec as JSpec
from modelopt_tpu_torch.core.bundle import PHASE_CALIB, _set_phase
from modelopt_tpu_torch.nn.quantizer import TensorQuantizer, quantization_active
from modelopt_tpu_torch.quant import backends as tb
from modelopt_tpu_torch.quant import fake_quant as tfq
from modelopt_tpu_torch.quant.config import get_config
from modelopt_tpu_torch.quant.qspec import QuantizerSpec as TSpec


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(M, K, N, seed=0):
    """bf16 activations with a few outlier rows and an int8-packed weight
    (the reference's quantize_int8 of a N(0, 1/K) kernel)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[::7] *= 20.0
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    p = jq.quantize_int8(jnp.asarray(w))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return xj, xt, p, pt


def _bits(a) -> np.ndarray:
    a = np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else
                   jnp.asarray(a, jnp.float32))
    return a.view(np.uint32)


@pytest.mark.parametrize("M", [300, 517])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_int8_dynamic_gemm_bit_exact(M, out):
    """At M = 300 and a ragged M = 517 (K = 256, N = 128): the same per-row
    codes, the exact s32 product and ``acc * xscale * scale`` in f32, so the
    port's result is the reference's bit for bit, in bf16 and in f32."""
    xj, xt, p, pt = _operands(M, 256, 128, seed=M)
    want = jb.int8_dynamic_gemm(xj, p["data"], p["scale"], getattr(jnp, out))
    got = tb.int8_dynamic_gemm(xt, pt["data"], pt["scale"], getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (M, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_qgemm_routes_int8_activations_to_dynamic_gemm(monkeypatch):
    """qgemm sends int8 weights with int8 activations above 256 rows to
    int8_dynamic_gemm (before any per-token fake-quant, as the reference
    orders its branches) and 256 rows or fewer to K7 w8a16_gemm's route;
    its result is the reference qgemm's bit for bit at 300 rows."""
    calls = []
    real = tb.int8_dynamic_gemm
    monkeypatch.setattr(tb, "int8_dynamic_gemm", lambda *a: calls.append(a[0].shape) or real(*a))
    spec = TSpec(num_bits=8, axis=(-1,))
    xj, xt, p, pt = _operands(300, 256, 128)
    for act_raw in (False, True):
        got = tb.qgemm(xt, pt, spec, (256, 128), act_int8=True, act_raw=act_raw)
    want = jb.qgemm(xj, p, JSpec(num_bits=8, axis=(-1,)), (256, 128), act_int8=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    tb.qgemm(xt[:256], pt, spec, (256, 128), act_int8=True)
    tb.qgemm(xt, pt, spec, (256, 128))  # bf16 activations: the dequantize path
    assert calls == [(300, 256), (300, 256)]


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)], ids=["dense", "experts"])
def test_per_channel_int8_calibration_and_fake_quant(shape):
    """A per-channel int8 weight spec (``axis=(-1,)``, the INT8 presets'):
    the port's CALIB phase keeps the reference's running amax over the
    leading axes ([out], an [E, in, out] kernel's too), and QUANT fake-
    quantizes with it as the reference's quantizer does, bit for bit;
    per-channel fp stays refused."""
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(shape).astype(np.float32) * s for s in (1.0, 3.0)]
    spec = JSpec(num_bits=8, axis=(-1,))
    want_amax = None
    for x in xs:
        stat, kind = _stat_shape_and_value(jnp.asarray(x), spec)
        assert kind == "trailing"
        want_amax = stat if want_amax is None else jnp.maximum(want_amax, stat)
    want = jfq.fake_quantize(jnp.asarray(xs[0]), spec,
                             amax=_broadcast_amax(want_amax, jnp.asarray(xs[0])))
    q = TensorQuantizer()
    q.path = "layers_0/mlp/down_proj/weight_quantizer"
    with quantization_active(get_config("INT8_DEFAULT_CFG")):
        with _set_phase(PHASE_CALIB):
            for x in xs:
                q(torch.from_numpy(x))
        got = q(torch.from_numpy(xs[0]))
    np.testing.assert_array_equal(q.amax.numpy(), np.asarray(want_amax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a dynamic per-channel call (amax from the call itself) too
    np.testing.assert_array_equal(
        tfq.fake_quantize(torch.from_numpy(xs[1]), TSpec(num_bits=8, axis=(-1,))).numpy(),
        np.asarray(jfq.fake_quantize(jnp.asarray(xs[1]), spec)))
    with pytest.raises(NotImplementedError):
        tfq.fake_quantize(torch.from_numpy(xs[0]), TSpec(num_bits=(4, 3), axis=(-1,)))
