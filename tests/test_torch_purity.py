"""The port stands alone: no module of modelopt_tpu_torch, and none of
chip_smoke.py, attention_ab.py and svd_timing.py, imports JAX or anything
of the JAX package (modelopt_tpu)."""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "modelopt_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "attention_ab.py", ROOT / "svd_timing.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+modelopt_tpu\.(?!_torch)|"
    r"import\s+modelopt_tpu\s*$|from\s+modelopt_tpu\s+import\b|"
    r"from\s+modelopt_tpu\.(?!_torch))", re.M)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_pattern_catches_reference_imports():
    bad = ["import jax", "from jax import numpy", "import modelopt_tpu.quant",
           "from modelopt_tpu import quant", "from modelopt_tpu.models import x",
           "import modelopt_tpu"]
    good = ["import modelopt_tpu_torch.quant", "from modelopt_tpu_torch import kernels",
            "from modelopt_tpu_torch.models import x", "import jaxlib_like_name_x"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)
