"""xbitops_tpu_torch -- the PyTorch and CUDA port of ``xbitops_tpu`` for NVIDIA
Hopper (H100).

Weight-only quantized Llama inference: packed 1-8-bit weights (the JAX
package's format v3), hand-written CUDA kernels for the fused dequant-matmul,
decode attention and KV append (``csrc/``, built with nvcc at first use), a
Llama model and a continuous-batching engine.  The JAX package stays the
reference; the tests hold this package against it.
"""
