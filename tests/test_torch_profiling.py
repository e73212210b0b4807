"""The port's decode roofline accounting (``utils/profiling.py``) against the
JAX package's on the same tiny model, carried across by ``params_from_numpy``:
the weight bytes equal JAX's count exactly, and the cache bytes a step equal
JAX's at 2 bytes an element (bf16, fp16) and twice that at 4 (f32).  These
mirror ``tests/test_profiling.py``."""

import jax
import numpy as np
import pytest
import torch

from xbitops_tpu.models import llama as jllama
from xbitops_tpu.utils import profiling as jprofiling
from xbitops_tpu.utils import synth as jsynth
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.utils.profiling import (
    H100_HBM_GBPS,
    decode_roofline,
    kv_step_bytes,
    model_weight_bytes,
)

torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(jsynth.random_llama_params, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), JCFG, 4, 32)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def test_weight_bytes_counts_packed_and_dense(jparams, model):
    wb = model_weight_bytes(model)
    assert wb == jprofiling.model_weight_bytes(jparams)
    # at least the packed planes of every projection, but not the embedding
    plane_bytes = sum(p.numel() * 4 for b in model.blocks for m in b.children()
                      for p in m.qtensor.planes)
    assert wb >= plane_bytes
    every = sum(t.numel() * t.element_size() for t in model.buffers())
    assert wb <= every - model.embed.numel() * model.embed.element_size()


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_roofline_report(jparams, model, dtype_bytes):
    r = decode_roofline(model, CFG, batch=2, mean_len=16, measured_ms=1.0,
                        dtype_bytes=dtype_bytes)
    assert r.cache_bytes == kv_step_bytes(CFG, 2, 16, dtype_bytes)
    assert r.cache_bytes == jprofiling.kv_step_bytes(JCFG, 2, 16, dtype_bytes)
    assert r.cache_bytes == dtype_bytes // 2 * jprofiling.kv_step_bytes(JCFG, 2, 16)
    assert r.weight_bytes == jprofiling.model_weight_bytes(jparams)
    assert r.hbm_gbps_peak == H100_HBM_GBPS == 3350.0
    assert r.bound_ms == pytest.approx(r.total_bytes / 3350e6)
    assert 0 < r.bound_ms < 1.0 and 0 < r.efficiency < 1.0
    assert "roofline" in str(r)
    assert decode_roofline(model, CFG, batch=2).measured_ms is None
