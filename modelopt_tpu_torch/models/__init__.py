"""Decoder models, synthetic compressed bundles, reference-weight import."""

from .transformer import (
    Decoder,
    DecoderConfig,
    llama3_8b_config,
    llama_config,
    make_cache,
    tiny_test_config,
)

__all__ = ["Decoder", "DecoderConfig", "llama3_8b_config", "llama_config",
           "make_cache", "tiny_test_config"]
