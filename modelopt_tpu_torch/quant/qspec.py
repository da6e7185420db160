"""QuantizerSpec — the static description of one quantizer.

Port of ``modelopt_tpu/quant/qspec.py``. Frozen and hashable, so resolved
specs can be cached per quantizer path; all dynamic state (amax) lives on
the quantizer modules, never on the spec.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .formats import FPFormat, parse_format


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Block-quantization layout: ``sizes`` maps axis -> block size (0 = the
    whole axis, i.e. per-row scales); ``dynamic`` selects per-call scales."""

    sizes: tuple
    dynamic: bool = True
    scale_format: Optional[str] = None
    two_level: bool = False
    four_over_six: bool = False

    @staticmethod
    def from_dict(d: dict) -> "BlockSpec":
        sizes = tuple(sorted((int(k), int(v)) for k, v in d.items()
                             if isinstance(k, int) or (isinstance(k, str) and k.lstrip("-").isdigit())))
        return BlockSpec(
            sizes=sizes,
            dynamic=d.get("type", "dynamic") == "dynamic",
            scale_format=d.get("scale_format"),
            two_level=bool(d.get("two_level", d.get("scale_format") is not None)),
            four_over_six=bool(d.get("four_over_six", False)),
        )


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static config of one tensor quantizer (attributes as in the
    reference's QuantizerAttributeConfig): num_bits (int, or (E, M) for FP),
    axis (kept dims of amax; None = per-tensor), block, unsigned,
    narrow_range, enable, fake, dynamic, bias_mode, rotate, calibrator,
    learn_amax, variant."""

    num_bits: Any = 8
    axis: Optional[tuple] = None
    block: Optional[BlockSpec] = None
    unsigned: bool = False
    narrow_range: bool = False
    enable: bool = True
    fake: bool = True
    dynamic: bool = False
    bias_mode: Optional[str] = None
    rotate: bool = False
    calibrator: str = "max"
    learn_amax: bool = False
    variant: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.num_bits, list):
            object.__setattr__(self, "num_bits", tuple(self.num_bits))
        if self.block is not None and not isinstance(self.block, BlockSpec):
            object.__setattr__(self, "block", BlockSpec.from_dict(dict(self.block)))
        if isinstance(self.axis, int):
            object.__setattr__(self, "axis", (self.axis,))
        elif isinstance(self.axis, list):
            object.__setattr__(self, "axis", tuple(self.axis))

    @property
    def is_fp(self) -> bool:
        return not isinstance(self.num_bits, int)

    @property
    def fp_format(self) -> FPFormat:
        assert self.is_fp
        return parse_format(self.num_bits)

    @property
    def int_bound(self) -> int:
        assert not self.is_fp
        return 2 ** (self.num_bits - (0 if self.unsigned else 1)) - 1

    @property
    def maxval(self) -> float:
        """Largest representable magnitude at unit scale."""
        return float(self.fp_format.maxval) if self.is_fp else float(self.int_bound)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "QuantizerSpec":
        if d is None:
            return QuantizerSpec(enable=False)
        d = dict(d)
        if "block_sizes" in d and d["block_sizes"] is not None:
            d["block"] = BlockSpec.from_dict(d.pop("block_sizes"))
        else:
            d.pop("block_sizes", None)
        nb = d.get("num_bits")
        if isinstance(nb, list):
            d["num_bits"] = tuple(nb)
        known = {f.name for f in dataclasses.fields(QuantizerSpec)}
        return QuantizerSpec(**{k: v for k, v in d.items() if k in known})

