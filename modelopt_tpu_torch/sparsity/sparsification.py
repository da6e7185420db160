"""The sparsity mode registry (port of the registry of
``modelopt_tpu/sparsity/sparsification.py``). The weight-sparsity modes
(magnitude N:M, SparseGPT) and ``sparsify`` / ``export_sparse`` are not
ported yet; ``skip_softmax`` registers its mode here."""

from __future__ import annotations

from ..core.mode import ModeRegistry

SparsityModeRegistry = ModeRegistry("sparsity")
