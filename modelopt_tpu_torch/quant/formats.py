"""Low-precision floating-point format math.

Port of ``modelopt_tpu/quant/formats.py``: the (E, M) format table and
``cast_to_fp``, which rounds to the nearest value of the format by
exponent-field extraction and grid rounding (round half to even, the
format's subnormals kept, saturating at its largest finite value, no inf
or NaN codes). The steps are exact powers of two assembled from their
bits, so the result is bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A miniature floating-point format with E exponent and M mantissa
    bits; ``maxval`` is its largest finite magnitude."""

    exp_bits: int
    man_bits: int
    maxval: float

    @property
    def bias(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def emax(self) -> int:
        # fn-style: the all-ones exponent holds normal values
        return (2 ** self.exp_bits - 1) - self.bias

    @property
    def min_normal_exp(self) -> int:
        return 1 - self.bias


_FORMATS = {
    (2, 1): FPFormat(2, 1, 6.0),        # e2m1  (FP4)
    (3, 2): FPFormat(3, 2, 28.0),       # e3m2  (FP6)
    (2, 3): FPFormat(2, 3, 7.5),        # e2m3  (FP6)
    (4, 3): FPFormat(4, 3, 448.0),      # e4m3fn (FP8)
    (5, 2): FPFormat(5, 2, 57344.0),    # e5m2  (FP8)
    (8, 0): FPFormat(8, 0, 2.0 ** 127),  # e8m0  (MX block scale, power of two)
    (3, 4): FPFormat(3, 4, 30.0),       # e3m4
    (1, 2): FPFormat(1, 2, 3.5),        # e1m2
}


@lru_cache(maxsize=None)
def get_format(exp_bits: int, man_bits: int) -> FPFormat:
    fmt = _FORMATS.get((exp_bits, man_bits))
    if fmt is None:
        # derived: mantissa up to 2 - 2^-M, the all-ones exponent usable
        bias = 2 ** (exp_bits - 1) - 1
        emax = (2 ** exp_bits - 1) - bias
        fmt = FPFormat(exp_bits, man_bits, float(2.0 ** emax * (2.0 - 2.0 ** -man_bits)))
    return fmt


def parse_format(name_or_tuple) -> FPFormat:
    """``"e2m1"``, ``(2, 1)`` or an FPFormat -> FPFormat."""
    if isinstance(name_or_tuple, FPFormat):
        return name_or_tuple
    if isinstance(name_or_tuple, str):
        s = name_or_tuple.lower()
        if not (s.startswith("e") and "m" in s):
            raise ValueError(f"Unrecognized FP format string: {name_or_tuple!r}")
        e, m = s[1:].split("m")
        return get_format(int(e), int(m))
    if isinstance(name_or_tuple, (tuple, list)) and len(name_or_tuple) == 2:
        return get_format(int(name_or_tuple[0]), int(name_or_tuple[1]))
    raise ValueError(f"Unrecognized FP format spec: {name_or_tuple!r}")


_DIVISORS: dict = {}


def true_divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded once, on every device. PyTorch computes a CUDA
    tensor over a Python float as x times the float's reciprocal, at times
    an ulp from the CPU's quotient; a 0-d divisor on x's device gives the
    true quotient on both (cached: no launch fills it again)."""
    key = (x.device, float(value))
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.tensor(float(value), device=x.device)
    return x / d


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e in f32 for integer e in [-126, 127], by assembling the
    exponent field."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(|x|)) for normal f32 x, from the exponent field."""
    bits = x.float().abs().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def cast_to_fp(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Round ``x`` to the nearest value of ``fmt`` (round half to even),
    saturating; returns ``x``'s dtype. Zeros and f32-subnormal inputs give
    +0, as in the reference (XLA flushes subnormal inputs to zero). e4m3
    goes through torch's float8_e4m3fn cast, the same grid and rounding in
    fewer launches (FP8_DEFAULT_CFG fake-quantizes every projection's input
    with it). Formats with no mantissa (e8m0, the MX scales, which the
    reference rounds through approximate log2 / exp2) raise."""
    if fmt.man_bits == 0:
        raise NotImplementedError("e8m0 (MX block scales) is not ported")
    orig_dtype = x.dtype
    xf = x.float()
    if (fmt.exp_bits, fmt.man_bits) == (4, 3):
        # the cast does not saturate: clip first
        q = torch.clamp(xf, -fmt.maxval, fmt.maxval).to(torch.float8_e4m3fn).float()
        return torch.where(xf.abs() < 2.0**-126, 0.0, q).to(orig_dtype)
    mag = xf.abs()
    fe = (mag.view(torch.int32) >> 23) & 0xFF  # the f32 exponent field
    e = torch.clamp(fe - 127, fmt.min_normal_exp, fmt.emax)
    step = exp2_int(e - fmt.man_bits)
    q = torch.round(xf / step) * step  # torch.round: half to even
    q = torch.clamp(q, -fmt.maxval, fmt.maxval)
    return torch.where(fe == 0, torch.zeros_like(q), q).to(orig_dtype)
