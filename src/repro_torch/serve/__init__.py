"""Serving of the port: the generation engine (prefill, cache, per-row
decode) and the paper's length-bucketed admission scheduler."""

from .engine import Engine, GenerationResult
from .scheduler import BucketedScheduler, Request

__all__ = ["Engine", "GenerationResult", "BucketedScheduler", "Request"]
