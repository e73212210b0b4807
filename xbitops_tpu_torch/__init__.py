"""xbitops_tpu_torch -- the PyTorch and CUDA port of ``xbitops_tpu`` for NVIDIA
Hopper (H100).

Weight-only quantized Llama inference: packed 1-8-bit weights (the JAX
package's format v3), hand-written CUDA kernels for the fused dequant-matmul
(bf16 and int8 activations), the dequantizer, decode and prefill attention and
KV append (``csrc/``, built with nvcc at first use), a quantizer, a Llama
model and a continuous-batching engine, with tensor and expert parallelism
over ``torch.distributed`` (``parallel/``, one process a rank).  The JAX
package stays the reference; the tests hold this package against it.

Reference-compatible surface, on the GPTQ interchange layout:
    - :func:`dequant`: unpack 1-8-bit packed weights to fp16 / bf16 / f32
    - :func:`gemv`: fused dequantize + GEMV/GEMM

Native surface:
    - :class:`QTensor`, :func:`from_gptq`, :func:`make_qtensor`,
      :func:`quantize_array`, :func:`requantize_a8`: the packed layout
    - :func:`qmatmul`, :func:`dequant_qtensor`: ops on a QTensor
"""

from xbitops_tpu_torch.formats import (  # noqa: F401
    PLANE_DECOMP,
    QTensor,
    from_gptq,
    gptq_pack,
    gptq_unpack_weight,
    gptq_unpack_zeros,
    make_qtensor,
    quantize,
)
from xbitops_tpu_torch.ops.dequant import dequant, dequant_qtensor  # noqa: F401
from xbitops_tpu_torch.ops.qmatmul import gemv, qmatmul  # noqa: F401
from xbitops_tpu_torch.ops.quantize import quantize_array, requantize_a8  # noqa: F401
