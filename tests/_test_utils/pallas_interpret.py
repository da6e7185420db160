"""Run the JAX package's Pallas kernels on the CPU as on a TPU, for the
PyTorch port's engine parity tests."""

import contextlib

import pytest
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import attention, block_sparse_attention, flash_attention, \
    paged_attention
from modelopt_tpu.quant import backends
from modelopt_tpu_torch.models import transformer as port_transformer


def _block_sparse_rule(B, KH, G, D, block_size):
    """``block_sparse_ok`` without its backend test."""
    return D % 128 == 0 and block_size % 8 == 0 and KH * G >= 1 and block_size * KH >= 128


def _flash_attention_rule(T, S, D):
    """``flash_attention_ok`` without its backend test."""
    return D % 64 == 0 and S % 128 == 0 and S <= 8192


def _fused_decode_rule(q_shape, S, cache_dtype=None):
    """``fused_decode_ok`` without its backend test."""
    return S <= 8192 and q_shape[-1] % 128 == 0 and S % 8 == 0


def _flash_prefill_rule(T, S, D, cache_dtype=None):
    """``flash_prefill_ok`` without its backend test."""
    return D % 64 == 0 and S % 128 == 0 and S <= 8192 and T >= 64


def _decode_attention_rule(q_shape, S, cache_dtype=None):
    """``decode_attention_ok`` without its backend test."""
    import jax.numpy as jnp

    return (cache_dtype in (jnp.float8_e4m3fn, jnp.int8) and S <= 8192
            and q_shape[-1] % 128 == 0)


def _paged_attention_rule(B, KH, G, D, page_size):
    """``paged_attention_ok`` without its backend test."""
    return D % 128 == 0 and page_size % 8 == 0


@contextlib.contextmanager
def reference_shape_rules(monkeypatch):
    """The JAX package's attention gates decide by their shape rules alone,
    as on a TPU (``fused_decode_ok``, ``flash_prefill_ok``,
    ``decode_attention_ok``, ``paged_attention_ok``, ``block_sparse_ok``,
    ``flash_attention_ok``), and a kernel they admit runs in interpret
    mode. The port's gates are left as they are."""
    for mod, name, rule in ((attention, "fused_decode_ok", _fused_decode_rule),
                            (flash_attention, "flash_prefill_ok", _flash_prefill_rule),
                            (attention, "decode_attention_ok", _decode_attention_rule),
                            (paged_attention, "paged_attention_ok", _paged_attention_rule),
                            (block_sparse_attention, "block_sparse_ok", _block_sparse_rule),
                            (flash_attention, "flash_attention_ok", _flash_attention_rule)):
        monkeypatch.setattr(mod, name, rule)
    with pltpu.force_tpu_interpret_mode():
        yield


@contextlib.contextmanager
def pallas_interpreted(monkeypatch, prefill_and_gemms: bool = False):
    """The gates that send CPU calls to the XLA paths return True, and the
    kernels run in interpret mode. Always the decode attention gates (dense,
    MLA, paged), and block-sparse decode and cache-free flash attention
    under their own shape rules (shapes they refuse on a TPU still take the
    XLA paths); with ``prefill_and_gemms`` also cached-prefill flash
    attention and the quantized GEMMs. The port's dense-cache gates
    (``fused_decode_ok``, ``flash_prefill_ok``, where its transformer looks
    them up) return True too, so that its kernels' plain twins stay held to
    the reference's kernels at the tests' tiny widths."""
    gates = [(attention, "fused_decode_ok"), (attention, "decode_attention_ok"),
             (paged_attention, "paged_attention_ok"),
             (port_transformer, "fused_decode_ok"), (port_transformer, "flash_prefill_ok")]
    if prefill_and_gemms:
        gates += [(flash_attention, "flash_prefill_ok"), (backends, "_pallas_ok")]
    for mod, name in gates:
        monkeypatch.setattr(mod, name, lambda *a, **k: True)
    monkeypatch.setattr(block_sparse_attention, "block_sparse_ok", _block_sparse_rule)
    monkeypatch.setattr(flash_attention, "flash_attention_ok", _flash_attention_rule)
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def interpreted_kernels(monkeypatch):
    """The JAX engine through its Pallas decode kernels in interpret mode.
    Both engines then round attention the same way (7-bit probability codes
    per chunk or page), so greedy parity no longer depends on the prompts'
    top-2 gaps."""
    with pallas_interpreted(monkeypatch):
        yield
