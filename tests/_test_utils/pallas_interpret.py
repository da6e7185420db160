"""Run the JAX package's Pallas kernels on the CPU as on a TPU, for the
PyTorch port's engine parity tests."""

import contextlib

import pytest
from jax.experimental.pallas import tpu as pltpu

from modelopt_tpu.kernels import attention, flash_attention, paged_attention
from modelopt_tpu.quant import backends


@contextlib.contextmanager
def pallas_interpreted(monkeypatch, prefill_and_gemms: bool = False):
    """The gates that send CPU calls to the XLA paths return True, and the
    kernels run in interpret mode. Always the decode attention gates (dense,
    MLA, paged); with ``prefill_and_gemms`` also cached-prefill flash
    attention and the quantized GEMMs."""
    gates = [(attention, "fused_decode_ok"), (attention, "decode_attention_ok"),
             (paged_attention, "paged_attention_ok")]
    if prefill_and_gemms:
        gates += [(flash_attention, "flash_prefill_ok"), (backends, "_pallas_ok")]
    for mod, name in gates:
        monkeypatch.setattr(mod, name, lambda *a, **k: True)
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
