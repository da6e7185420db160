"""Decoder models, synthetic compressed bundles, reference-weight import."""

from .transformer import (
    Decoder,
    DecoderConfig,
    llama3_8b_config,
    llama_config,
    make_cache,
    qwen3_moe_config,
    tiny_moe_test_config,
    tiny_test_config,
)

__all__ = ["Decoder", "DecoderConfig", "llama3_8b_config", "llama_config",
           "make_cache", "qwen3_moe_config", "tiny_moe_test_config", "tiny_test_config"]
