"""modelopt_tpu_torch — the PyTorch/CUDA port of modelopt_tpu.

The JAX package ``modelopt_tpu`` stays the reference; this package keeps its
layout (core, quant, nn, kernels, models, serve) so each module has one
counterpart there. It imports torch and nothing of JAX or of the JAX
package. Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, where every kernel wrapper computes its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
