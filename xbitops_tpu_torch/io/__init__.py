"""Checkpoints: the packed format (v3) both packages share, and AutoGPTQ."""

from xbitops_tpu_torch.io.checkpoint import load_packed, save_packed  # noqa: F401
from xbitops_tpu_torch.io.gptq_loader import llama_config_from_hf, load_autogptq  # noqa: F401
