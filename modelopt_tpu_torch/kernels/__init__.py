"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
twin. Every wrapper counts its launches in a ``launches`` attribute. (K14
``flash_attention`` is reached through its module, ``kernels.flash_attention``,
whose name it shares. K3's ``dense_kv_write_pair`` and K16's
``paged_kv_write_rows`` count under ``dense_kv_write`` and ``paged_kv_write``.)"""

from .attention import decode_attention, dense_kv_write, fused_decode_attention
from .block_sparse_attention import block_sparse_decode_attention
from . import flash_attention as _flash
from .flash_attention import flash_prefill_attention
from .paged_attention import paged_decode_attention, paged_kv_write
from .quant_gemm import (grouped_nvfp4_gemm, grouped_w4a8_combine_gemm, grouped_w4a8_gemm,
                         grouped_w4a16_gemm, nvfp4_gemm, w4a8_gemm, w4a16_gemm, w8a16_gemm,
                         wfp8_gemm)

KERNELS = {
    "w4a8_gemm": w4a8_gemm,
    "dense_kv_write": dense_kv_write,
    "fused_decode_attention": fused_decode_attention,
    "flash_prefill_attention": flash_prefill_attention,
    "w4a16_gemm": w4a16_gemm,
    "grouped_w4a16_gemm": grouped_w4a16_gemm,
    "grouped_w4a8_combine_gemm": grouped_w4a8_combine_gemm,
    "decode_attention": decode_attention,
    "paged_decode_attention": paged_decode_attention,
    "paged_kv_write": paged_kv_write,
    "w8a16_gemm": w8a16_gemm,
    "wfp8_gemm": wfp8_gemm,
    "nvfp4_gemm": nvfp4_gemm,
    "grouped_nvfp4_gemm": grouped_nvfp4_gemm,
    "block_sparse_decode_attention": block_sparse_decode_attention,
    "flash_attention": _flash.flash_attention,
    "grouped_w4a8_gemm": grouped_w4a8_gemm,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
