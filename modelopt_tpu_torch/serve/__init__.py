"""Serving: continuous-batching engine and the end-to-end benchmark."""

from .benchmark import run_serving_benchmark
from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine", "run_serving_benchmark"]
