"""Nested-dict path helper (port of ``flatten_with_paths`` from
``modelopt_tpu/core/tree.py``), used to read a reference variables tree leaf
by leaf."""

from __future__ import annotations

from typing import Any


def flatten_with_paths(tree: Any, prefix=()):
    """Yield ('/'-joined path, leaf) pairs for a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_paths(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), tree
