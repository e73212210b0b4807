"""Continuous-batching serving engine."""

from xbitops_tpu_torch.engine.engine import Completion, Engine, Request  # noqa: F401
