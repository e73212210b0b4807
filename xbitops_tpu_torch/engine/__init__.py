"""Continuous-batching serving engine and its HTTP endpoint."""

from xbitops_tpu_torch.engine.engine import Completion, Engine, Request  # noqa: F401
