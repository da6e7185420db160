"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
twin. Every wrapper counts its launches in a ``launches`` attribute."""

from .attention import dense_kv_write, fused_decode_attention
from .flash_attention import flash_prefill_attention
from .quant_gemm import w4a8_gemm

KERNELS = {
    "w4a8_gemm": w4a8_gemm,
    "dense_kv_write": dense_kv_write,
    "fused_decode_attention": fused_decode_attention,
    "flash_prefill_attention": flash_prefill_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
