"""Hadamard rotation for outlier-smoothed quantization.

Port of ``modelopt_tpu/quant/rotation.py``: quantize in a rotated basis
where outliers are spread across the whole vector, then rotate back. The
normalized Sylvester-Hadamard matrix is symmetric and involutory
(H = H^T = H^-1), so one transform applies and undoes the rotation. It is
built on the host in f32, as the reference builds it in numpy, and
applied as one f32 [d, d] product on the last axis (the KV presets rotate
q / k / v over the head dim).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _hadamard_np(d: int) -> np.ndarray:
    if d & (d - 1) != 0 or d < 1:
        raise ValueError(f"Hadamard rotation needs a power-of-2 dim, got {d}")
    h = np.asarray([[1.0]], np.float32)
    while h.shape[0] < d:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(d)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def hadamard_matrix(d: int, device: torch.device) -> torch.Tensor:
    """The normalized [d, d] Hadamard matrix in f32 on ``device`` (cached)."""
    return torch.from_numpy(_hadamard_np(d)).to(device)


def hadamard_rotate(x: torch.Tensor) -> torch.Tensor:
    """Rotate the last axis by the normalized Hadamard matrix in f32, back
    in x's dtype (involutory: apply twice to undo)."""
    h = hadamard_matrix(x.shape[-1], x.device)
    return torch.matmul(x.float(), h).to(x.dtype)
