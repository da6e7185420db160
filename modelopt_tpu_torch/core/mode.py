"""Mode descriptors and registries (port of ``modelopt_tpu/core/mode.py``).

A *mode* is a named, configurable, replayable model transform
(reference: modelopt/torch/opt/mode.py:56 ModeDescriptor,
:277 _ModeRegistryCls). Examples: "quantize", "kd_loss", "sparse_magnitude",
"eagle". Each technique package owns a registry; all registries share a
global name index so a state stack can be replayed without knowing which
package a mode came from.
"""

from __future__ import annotations

from typing import Callable


class ModeDescriptor:
    """Interface of one mode.

    Subclasses define:
      name:          unique mode name.
      convert:       (bundle, config) -> (bundle, metadata).
      runtime_context: optional contextmanager active while a converted
                     bundle is applied (e.g. "quantize" activates its config
                     so quantizer submodules resolve specs).
    """

    name: str = ""

    def convert(self, bundle, config):
        raise NotImplementedError

    def runtime_context(self, config, phase):
        return None  # no-op; ModelBundle skips None contexts


class ModeRegistry:
    """Per-technique mode registry with a shared global index
    (reference: opt/mode.py:277 _ModeRegistryCls)."""

    _global: dict[str, "ModeDescriptor"] = {}

    def __init__(self, technique: str):
        self.technique = technique

    def register(self, descriptor_cls: Callable[[], ModeDescriptor]):
        desc = descriptor_cls() if isinstance(descriptor_cls, type) else descriptor_cls
        if not desc.name:
            raise ValueError(f"mode descriptor {desc} has no name")
        if desc.name in ModeRegistry._global:
            raise ValueError(f"mode {desc.name!r} already registered")
        ModeRegistry._global[desc.name] = desc
        return descriptor_cls


def get_mode(name: str) -> ModeDescriptor:
    try:
        return ModeRegistry._global[name]
    except KeyError:
        raise KeyError(
            f"Unknown mode {name!r}. Registered: {sorted(ModeRegistry._global)}"
        ) from None
