"""Decoder models, synthetic compressed bundles, reference-weight import."""

from .transformer import (
    Decoder,
    DecoderConfig,
    deepseek_v2_lite_config,
    llama3_8b_config,
    llama_config,
    make_cache,
    qwen3_moe_config,
    small_mla_compressed_config,
    tiny_mla_test_config,
    tiny_moe_test_config,
    tiny_test_config,
)

__all__ = ["Decoder", "DecoderConfig", "deepseek_v2_lite_config", "llama3_8b_config",
           "llama_config", "make_cache", "qwen3_moe_config", "small_mla_compressed_config",
           "tiny_mla_test_config", "tiny_moe_test_config", "tiny_test_config"]
