"""Quantization config: ordered wildcard rules + named presets.

Port of ``modelopt_tpu/quant/config.py``: the same rule engine (ordered
fnmatch rules on quantizer paths such as
``layers_0/attn/qkv_proj/weight_quantizer``, later matches overriding
earlier ones attribute by attribute) and, of the presets, those the
serving paths and the ported calibration algorithms run:
``W4A8_INT8KV_CFG``, ``W4A8_INT8_DYNAMIC_CFG``, ``INT8_KV_CFG``,
``INT8_DEFAULT_CFG``, ``INT8_SMOOTHQUANT_CFG``, ``INT4_AWQ_CFG``,
``INT4_AWQ_CLIP_CFG``, ``INT4_AWQ_FULL_CFG``,
``INT4_BLOCKWISE_WEIGHT_ONLY_CFG`` (W4A16),
``INT8_WEIGHT_ONLY_CFG``, ``FP8_DEFAULT_CFG`` (e4m3 weights and static
e4m3 activations), ``FP8_KV_CFG`` (the same with an e4m3 KV cache),
``FP8_WEIGHT_ONLY_CFG``, ``NVFP4_WEIGHT_ONLY_CFG``, its equal
``W4A16_NVFP4_CFG``, and the NVFP4 presets that quantize activations:
``NVFP4_DEFAULT_CFG``, ``NVFP4_AWQ_LITE_CFG``, ``NVFP4_AWQ_CLIP_CFG``,
``NVFP4_AWQ_FULL_CFG``, ``NVFP4_SVDQUANT_CFG``, ``NVFP4_MLP_ONLY_CFG``,
``W4A8_NVFP4_FP8_CFG`` (NVFP4 weights, static e4m3 activations),
``NVFP4_EXPERTS_ONLY_CFG`` (expert weights only), ``NVFP4_KV_CFG`` and
``NVFP4_KV_ROTATE_CFG`` (NVFP4 q / k / v in a Hadamard-rotated basis).

Layout convention (kept from the reference): weight kernels are
``[in_features, out_features]``, so per-output-channel weight scales are
``axis: (-1,)`` and input-dim blocks are ``{-2: 128}``.
"""

from __future__ import annotations

import dataclasses
from fnmatch import fnmatch
from functools import lru_cache
from typing import Any, Optional

from .qspec import QuantizerSpec


def _freeze(obj):
    if isinstance(obj, dict):
        # keys may mix ints (block axes) and strs (options); sort by repr
        return tuple(sorted(((k, _freeze(v)) for k, v in obj.items()), key=lambda kv: repr(kv[0])))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj):
    if isinstance(obj, tuple) and all(
        isinstance(i, tuple) and len(i) == 2 and isinstance(i[0], (str, int)) for i in obj
    ):
        return {k: _thaw(v) for k, v in obj}
    if isinstance(obj, tuple):
        return [_thaw(v) for v in obj]
    return obj


@dataclasses.dataclass(frozen=True)
class QuantizeConfig:
    """rules: ordered ``(pattern, frozen-attrs | tuple-of-frozen-attrs | None)``.

    A tuple of attr-dicts for one pattern builds a sequential quantizer chain
    (e.g. W4A8 = INT4 then FP8; reference: tensor_quantizer.py:1797
    SequentialQuantizer). ``None``/``{"enable": False}`` disables.
    """

    rules: tuple = ()
    algorithm: Any = "max"

    @staticmethod
    def from_dict(d: dict) -> "QuantizeConfig":
        quant_cfg = d.get("quant_cfg", d)
        rules = []
        for pattern, attrs in quant_cfg.items():
            if isinstance(attrs, (list, tuple)):
                # sequential quantizer chain: mark explicitly so (de)serialization
                # and resolution don't have to guess the nesting level
                rules.append((pattern, ("__seq__", tuple(_freeze(a) for a in attrs))))
            else:
                rules.append((pattern, _freeze(attrs)))
        alg = d.get("algorithm", "max")
        return QuantizeConfig(rules=tuple(rules), algorithm=_freeze(alg))

    def updated(self, extra_rules: dict) -> "QuantizeConfig":
        """Append rules (later rules win): ``disable_quantizer`` and the like."""
        extra = QuantizeConfig.from_dict({"quant_cfg": extra_rules})
        return dataclasses.replace(self, rules=self.rules + extra.rules)

    def resolve(self, path: str) -> Optional[tuple]:
        return _resolve_cached(self, path)

    @property
    def algorithm_name(self) -> Optional[str]:
        alg = _thaw(self.algorithm)
        if alg is None:
            return None
        return alg if isinstance(alg, str) else alg.get("method")

    @property
    def algorithm_kwargs(self) -> dict:
        alg = _thaw(self.algorithm)
        if isinstance(alg, dict):
            return {k: v for k, v in alg.items() if k != "method"}
        return {}


def _is_seq(attrs) -> bool:
    return isinstance(attrs, tuple) and len(attrs) == 2 and attrs[0] == "__seq__"


@lru_cache(maxsize=16384)
def _resolve_cached(cfg: QuantizeConfig, path: str):
    """Merge all matching rules in order → tuple of QuantizerSpec, or None."""
    merged: list[dict] = []
    matched = False
    for pattern, attrs in cfg.rules:
        if not fnmatch(path, pattern):
            continue
        matched = True
        if attrs is None:
            merged = [{"enable": False}]
        elif _is_seq(attrs):  # sequential chain replaces wholesale
            merged = [dict(_thaw(a)) for a in attrs[1]]
        else:
            thawed = _thaw(attrs)
            if len(merged) == 1:
                merged[0].update(thawed)
            else:
                merged = [dict(thawed)]
    if not matched:
        return None
    specs = tuple(QuantizerSpec.from_dict(a) for a in merged)
    if all(not s.enable for s in specs):
        return None
    return specs


# ---------------------------------------------------------------------------
# Named presets (the reference's quant/config.py:144-311)
# ---------------------------------------------------------------------------
# exclusions applied in every preset: LM head, routers and embeddings stay
# in 16 bits
_DEFAULT_DISABLED = {
    "*lm_head*": {"enable": False},
    "*router*": {"enable": False},
    "*embed*": {"enable": False},
}


def _cfg(weight: dict, act: Optional[dict] = None, extra: Optional[dict] = None,
         algorithm: Any = "max") -> dict:
    qc = {"*weight_quantizer": weight}
    qc["*input_quantizer"] = act if act is not None else {"enable": False}
    qc["*output_quantizer"] = {"enable": False}
    qc.update(_DEFAULT_DISABLED)
    if extra:
        qc.update(extra)
    return {"quant_cfg": qc, "algorithm": algorithm}


_W_INT8_PC = {"num_bits": 8, "axis": (-1,)}            # per-out-channel
_A_INT8_PT = {"num_bits": 8, "axis": None}             # per-tensor
_W_FP8 = {"num_bits": (4, 3), "axis": None}
_A_FP8 = {"num_bits": (4, 3), "axis": None}
_W_INT4_BLOCK = {"num_bits": 4, "block_sizes": {-2: 128}}
_W_NVFP4 = {
    "num_bits": (2, 1),
    "block_sizes": {-2: 16, "type": "dynamic", "scale_format": "e4m3", "two_level": True},
}
# dynamic NVFP4 activations: blocks of 16 along the feature dim, e4m3 block
# scales over a calibrated per-tensor amax
_A_NVFP4 = {
    "num_bits": (2, 1),
    "block_sizes": {-1: 16, "type": "dynamic", "scale_format": "e4m3", "two_level": True},
}
# per-token dynamic int8 activations (block of the whole feature dim)
_A_INT8_PER_TOKEN = {"num_bits": 8, "block_sizes": {-1: 0, "type": "dynamic"}}
# per-tensor static int8 KV-cache codes + f32 scale (needs calibration)
KV_CACHE_INT8 = {
    "*k_quantizer": {"num_bits": 8, "axis": None},
    "*v_quantizer": {"num_bits": 8, "axis": None},
}
# per-tensor static e4m3 KV-cache codes + f32 scale (a direct cast when
# uncalibrated)
KV_CACHE_FP8 = {
    "*k_quantizer": {"num_bits": (4, 3), "axis": None},
    "*v_quantizer": {"num_bits": (4, 3), "axis": None},
}
# NVFP4 fake-quantized k / v (the cache holds their 16-bit values)
KV_CACHE_NVFP4 = {"*k_quantizer": dict(_A_NVFP4), "*v_quantizer": dict(_A_NVFP4)}
# the same in a Hadamard-rotated head-dim basis, q included so the scores
# see one basis (quant/rotation.py)
KV_CACHE_NVFP4_ROTATE = {
    "*k_quantizer": dict(_A_NVFP4, rotate=True),
    "*v_quantizer": dict(_A_NVFP4, rotate=True),
    "*q_quantizer": dict(_A_NVFP4, rotate=True),
}

INT8_DEFAULT_CFG = _cfg(_W_INT8_PC, _A_INT8_PT)
INT8_SMOOTHQUANT_CFG = _cfg(_W_INT8_PC, _A_INT8_PT, algorithm="smoothquant")
INT4_AWQ_CFG = _cfg(_W_INT4_BLOCK, None, algorithm={"method": "awq_lite"})
INT4_AWQ_CLIP_CFG = _cfg(_W_INT4_BLOCK, None, algorithm={"method": "awq_clip"})
INT4_AWQ_FULL_CFG = _cfg(_W_INT4_BLOCK, None, algorithm={"method": "awq_full"})
W4A8_INT8_DYNAMIC_CFG = _cfg(_W_INT4_BLOCK, _A_INT8_PER_TOKEN,
                             algorithm={"method": "awq_lite"})
INT8_KV_CFG = _cfg(_W_INT8_PC, _A_INT8_PT, extra=KV_CACHE_INT8,
                   algorithm={"method": "smoothquant"})
W4A8_INT8KV_CFG = _cfg(_W_INT4_BLOCK, _A_INT8_PER_TOKEN, extra=KV_CACHE_INT8,
                       algorithm={"method": "awq_lite"})
INT4_BLOCKWISE_WEIGHT_ONLY_CFG = _cfg(_W_INT4_BLOCK, None)
INT8_WEIGHT_ONLY_CFG = _cfg(_W_INT8_PC, None)
FP8_DEFAULT_CFG = _cfg(_W_FP8, _A_FP8)
FP8_KV_CFG = _cfg(_W_FP8, _A_FP8, extra=KV_CACHE_FP8)
FP8_WEIGHT_ONLY_CFG = _cfg(_W_FP8, None)
NVFP4_WEIGHT_ONLY_CFG = _cfg(_W_NVFP4, None)
W4A16_NVFP4_CFG = _cfg(_W_NVFP4, None)
NVFP4_DEFAULT_CFG = _cfg(_W_NVFP4, _A_NVFP4)
NVFP4_AWQ_LITE_CFG = _cfg(_W_NVFP4, _A_NVFP4, algorithm={"method": "awq_lite"})
NVFP4_AWQ_CLIP_CFG = _cfg(_W_NVFP4, _A_NVFP4, algorithm={"method": "awq_clip"})
NVFP4_AWQ_FULL_CFG = _cfg(_W_NVFP4, _A_NVFP4, algorithm={"method": "awq_full"})
NVFP4_SVDQUANT_CFG = _cfg(_W_NVFP4, _A_NVFP4, algorithm={"method": "svdquant"})
NVFP4_MLP_ONLY_CFG = _cfg(
    {"enable": False}, {"enable": False},
    extra={"*mlp*weight_quantizer": _W_NVFP4, "*mlp*input_quantizer": _A_NVFP4},
)
W4A8_NVFP4_FP8_CFG = _cfg(_W_NVFP4, _A_FP8)
NVFP4_EXPERTS_ONLY_CFG = _cfg({"enable": False}, None,
                              extra={"*moe*weight_quantizer": _W_NVFP4})
NVFP4_KV_CFG = _cfg(_W_NVFP4, _A_NVFP4, extra=KV_CACHE_NVFP4)
NVFP4_KV_ROTATE_CFG = _cfg(_W_NVFP4, _A_NVFP4, extra=KV_CACHE_NVFP4_ROTATE)

choices = {
    "INT8_DEFAULT_CFG": INT8_DEFAULT_CFG,
    "INT8_SMOOTHQUANT_CFG": INT8_SMOOTHQUANT_CFG,
    "INT4_AWQ_CFG": INT4_AWQ_CFG,
    "INT4_AWQ_CLIP_CFG": INT4_AWQ_CLIP_CFG,
    "INT4_AWQ_FULL_CFG": INT4_AWQ_FULL_CFG,
    "W4A8_INT8_DYNAMIC_CFG": W4A8_INT8_DYNAMIC_CFG,
    "INT8_KV_CFG": INT8_KV_CFG,
    "W4A8_INT8KV_CFG": W4A8_INT8KV_CFG,
    "INT4_BLOCKWISE_WEIGHT_ONLY_CFG": INT4_BLOCKWISE_WEIGHT_ONLY_CFG,
    "INT8_WEIGHT_ONLY_CFG": INT8_WEIGHT_ONLY_CFG,
    "FP8_DEFAULT_CFG": FP8_DEFAULT_CFG,
    "FP8_KV_CFG": FP8_KV_CFG,
    "FP8_WEIGHT_ONLY_CFG": FP8_WEIGHT_ONLY_CFG,
    "NVFP4_WEIGHT_ONLY_CFG": NVFP4_WEIGHT_ONLY_CFG,
    "W4A16_NVFP4_CFG": W4A16_NVFP4_CFG,
    "NVFP4_DEFAULT_CFG": NVFP4_DEFAULT_CFG,
    "NVFP4_AWQ_LITE_CFG": NVFP4_AWQ_LITE_CFG,
    "NVFP4_AWQ_CLIP_CFG": NVFP4_AWQ_CLIP_CFG,
    "NVFP4_AWQ_FULL_CFG": NVFP4_AWQ_FULL_CFG,
    "NVFP4_SVDQUANT_CFG": NVFP4_SVDQUANT_CFG,
    "NVFP4_MLP_ONLY_CFG": NVFP4_MLP_ONLY_CFG,
    "W4A8_NVFP4_FP8_CFG": W4A8_NVFP4_FP8_CFG,
    "NVFP4_EXPERTS_ONLY_CFG": NVFP4_EXPERTS_ONLY_CFG,
    "NVFP4_KV_CFG": NVFP4_KV_CFG,
    "NVFP4_KV_ROTATE_CFG": NVFP4_KV_ROTATE_CFG,
}


def get_config(cfg) -> QuantizeConfig:
    """Accept a preset name, a raw dict, or an already-built QuantizeConfig."""
    if isinstance(cfg, QuantizeConfig):
        return cfg
    if isinstance(cfg, str):
        if cfg in choices:
            return QuantizeConfig.from_dict(choices[cfg])
        raise KeyError(f"Unknown quant preset {cfg!r}; available: {sorted(choices)}")
    return QuantizeConfig.from_dict(cfg)
