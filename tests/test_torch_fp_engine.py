"""The fifth slice end to end on the CPU: tiny models compressed by the JAX
package under FP8_DEFAULT_CFG (e4m3 weights and static e4m3 activations,
calibrated by the reference), INT8_WEIGHT_ONLY_CFG and NVFP4_WEIGHT_ONLY_CFG
(a Qwen3-MoE-shaped model: NVFP4 attention projections, folded expert
gate / up and the grouped expert down projection), carried into the port by
``from_jax_variables`` and held against the reference: cached logits, then
both serving engines token for token (the reference decoding through its
interpret-mode Pallas kernels)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelopt_tpu.core import PHASE_CALIB
from modelopt_tpu.core.bundle import ModelBundle, ModeRecord
from modelopt_tpu.core.tree import flatten_with_paths, set_in
from modelopt_tpu.models import transformer as jt
from modelopt_tpu.quant.compress import compress as jcompress
from modelopt_tpu.quant.config import get_config as jget_config
from modelopt_tpu.serve import ServingEngine as JaxEngine
from modelopt_tpu_torch.models import transformer as tt
from modelopt_tpu_torch.models.convert import from_jax_variables
from modelopt_tpu_torch.serve import ServingEngine
from tests._test_utils.pallas_interpret import pallas_interpreted


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool costs far more
    than it saves on them (50x on the engine tests), and the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP8, INT8, NVFP4 = "FP8_DEFAULT_CFG", "INT8_WEIGHT_ONLY_CFG", "NVFP4_WEIGHT_ONLY_CFG"
CASES = {FP8: "llama", INT8: "llama", NVFP4: "moe"}
# a llama with the attention kernels' head_dim and fused projections (paths
# G and H); the MoE routes every token to all 4 experts, so no top-k choice
# can flip between the packages
LLAMA = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
             head_dim=128, intermediate_size=512, max_position_embeddings=256,
             fused_qkv=True, fused_gate_up=True)
MOE = dict(experts_per_token=4)


def port_cfg(model, tdtype):
    if model == "llama":
        return tt.llama_config(dtype=tdtype, **LLAMA)
    return tt.tiny_moe_test_config(dtype=tdtype, **MOE)


def jax_cfg(tcfg, jdtype):
    """The reference's DecoderConfig with the port config's fields."""
    names = [f.name for f in dataclasses.fields(tcfg) if f.name not in ("dtype", "param_dtype")]
    return jt.DecoderConfig(dtype=jdtype, **{n: getattr(tcfg, n) for n in names})


def reference_pair(preset, tdtype, jdtype, seed=6):
    """The reference bundle: f32 weights drawn from numpy (kernels
    N(0, 1/fin) with a 4x lm_head, the router N(0, 0.01), norm scales
    1 + 0.1 N(0, 1), the embedding N(0, 1)), compressed by the reference's
    ``compress`` and, under a preset with static activation quantizers,
    calibrated by one JAX forward; and the port's copy of it."""
    tcfg = port_cfg(CASES[preset], tdtype)
    rng = np.random.default_rng(seed)
    module = jt.Decoder(jax_cfg(tcfg, jdtype))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), ids)["params"]
    params = {}
    for path, leaf in flatten_with_paths(shapes):
        keys = tuple(path.split("/"))
        if keys[-1] == "kernel" and "router" in keys:
            arr = rng.standard_normal(leaf.shape) * 0.1
        elif keys[-1] == "kernel":
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
            if "lm_head" in keys:
                arr = arr * 4.0
        elif keys[-1] == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            arr = rng.standard_normal(leaf.shape)
        params = set_in(params, keys, jnp.asarray(arr, jnp.float32))
    jb = jcompress(ModelBundle(module=module, variables={"params": params},
                               example_inputs=(ids,),
                               records=(ModeRecord("quantize", jget_config(preset), {}),)))
    if preset == FP8:
        cal = jnp.asarray(np.random.default_rng(1).integers(1, 512, (2, 8)), jnp.int32)
        calfn = jax.jit(jb.make_fn(phase=PHASE_CALIB, mutable=["quant"]))
        _, mut = calfn(jb.variables, cal, jt.make_cache(jb.module.cfg, 2, 32))
        jb = jb.replace(variables={**jb.variables, "quant": mut["quant"]})
    tb = from_jax_variables(jax.tree.map(np.asarray, jb.variables), tcfg, preset,
                            device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def bf16_pairs():
    return {p: reference_pair(p, torch.bfloat16, jnp.bfloat16) for p in CASES}


@pytest.mark.parametrize("preset", list(CASES))
def test_packed_weights_carried_bit_for_bit(bf16_pairs, preset):
    """Every packed leaf of the reference (e4m3 data and scales, NVFP4's
    codes, e4m3 block scales and scale2, int8 codes) lands in the port's
    buffers bit for bit, and the fp8 activations' calibrated amax with it."""
    jb, tb = bf16_pairs[preset]
    mods = {m.path: m for m in tb.module.modules()}
    leaves = [(p, np.asarray(v)) for p, v in flatten_with_paths(jb.variables["quant"])]
    packed = set()
    for path, arr in leaves:
        base, _, name = path.rpartition("/")
        if "/qweight" in path:
            base, name = path.split("/qweight/")
            got = getattr(mods[base], "qweight_" + name)
            packed.add(base)
        else:
            got = getattr(mods[base], name)
        raw = np.ascontiguousarray(arr)
        if raw.dtype.name == "float8_e4m3fn":
            assert got.dtype == torch.float8_e4m3fn
            np.testing.assert_array_equal(got.view(torch.uint8).numpy(), raw.view(np.uint8))
        else:
            np.testing.assert_array_equal(got.numpy().reshape(raw.shape), raw)
    # every projection of both layers: llama qkv, o, gate_up, down; the MoE
    # q, k, v, o and the three expert kernels
    assert len(packed) == 2 * (4 if CASES[preset] == "llama" else 7)
    if preset == NVFP4:
        assert all(m.qweight_scale2 is not None for m in mods.values()
                   if getattr(m, "compressed", False))


@pytest.mark.parametrize("preset", list(CASES))
def test_cached_logits_match_reference(bf16_pairs, preset):
    """Prefill of 2 x 8 then 4 teacher-forced decode steps into a bf16
    cache: the reference's CPU paths (dequantize + dot, einsum attention)
    against the port's kernels' twins (the new GEMMs at every M <= 256,
    K2 / K3 / K4 twins): within 4e-2 of the logit range, the prefill's
    greedy choices equal."""
    jb, tb = bf16_pairs[preset]
    cfg = tb.module.cfg
    ids = np.random.default_rng(3).integers(1, 512, (2, 12)).astype(np.int32)
    fn = jax.jit(jb.make_fn())
    jc = jt.make_cache(jb.module.cfg, 2, 32, dtype=jnp.bfloat16)
    tc = tt.make_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    lj, jc = fn(jb.variables, jnp.asarray(ids[:, :8]), jc)
    lt, tc = tb.apply(torch.from_numpy(ids[:, :8]), tc)
    want, got = [np.asarray(lj[:, -1], np.float32)], [lt[:, -1].float().numpy()]
    for t in range(8, 12):
        lj, jc = fn(jb.variables, jnp.asarray(ids[:, t:t + 1]), jc)
        lt, tc = tb.apply(torch.from_numpy(ids[:, t:t + 1]), tc)
        want.append(np.asarray(lj[:, -1], np.float32))
        got.append(lt[:, -1].float().numpy())
    want, got = np.stack(want), np.stack(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-2 * np.abs(want).max())
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


@pytest.fixture
def interpreted_kernels(monkeypatch):
    """Run the JAX engine through its Pallas kernels, as on a TPU: the
    gates that send CPU calls to the XLA paths return True (decode
    attention, cached-prefill flash attention, the quantized GEMMs), and
    the kernels run in interpret mode. Both engines then round as the
    kernels do (x to bf16 in the GEMMs, attention probabilities per chunk):
    FP8's e4m3 activation codes turn the XLA paths' other roundings into
    other greedy tokens on this tiny model."""
    with pallas_interpreted(monkeypatch, prefill_and_gemms=True):
        yield


@pytest.mark.parametrize("preset", list(CASES))
def test_greedy_tokens_match_reference_engine(preset, interpreted_kernels):
    """Three staggered requests (numpy seed 5; the second streams in
    chunks of 16 + 4, the third arrives after two ticks) through both
    engines, f32 model dtype and cache, the reference through its Pallas
    kernels (the MoE's grouped down projection stays on its XLA path: its
    gate needs a TPU backend): the same tokens and stop reasons, log-probs
    within 0.15."""
    jb, tb = reference_pair(preset, torch.float32, jnp.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 20, 3)]
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(8, 16), max_admit=1)

    def serve(engine):
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts[:2]]
        for _ in range(2):
            engine.step()
        reqs.append(engine.submit(prompts[2], max_new_tokens=6))
        engine.run()
        return reqs

    want = serve(JaxEngine(jb, **kw))
    got = serve(ServingEngine(tb, device="cpu", **kw))
    for w, g in zip(want, got):
        assert g.done and g.stop_reason == w.stop_reason
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, atol=0.15)
