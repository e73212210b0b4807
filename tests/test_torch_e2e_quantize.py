"""The full user path of the port on STRUCTURED models (``utils/structured.py``),
as ``tests/test_e2e_quantize.py`` drives the JAX package's:

  dense HF checkpoint (successor-structured: a real perplexity to lose)
  -> ``python -m xbitops_tpu_torch quantize`` (the port's GPTQ, calibrated on
     structured streams) -> packed directory -> ``generate``

for a dense Llama and a Mixtral-layout MoE (per-expert Hessians from the
routed tokens), on the CPU.  Gates, the reference's: the dense source model
predicts successors (mean NLL < 0.1); the quantized NLL on held-out structured
text within 0.05 of the dense model's; ``generate`` prints the successor walk;
speculative decoding (γ=4, n-gram draft) gives plain greedy's tokens with an
acceptance above 0.5, and the walk.  The port's checkpoint writers give the
JAX writers' files tensor for tensor for the same seed."""

import dataclasses

import numpy as np
import pytest
import torch
from safetensors import numpy as st_np

from xbitops_tpu.models import llama as jllama
from xbitops_tpu.models import moe as jmoe
from xbitops_tpu.utils import structured as jstructured
from xbitops_tpu_torch.cli import main
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.io import load_autogptq
from xbitops_tpu_torch.io.checkpoint import load_llama
from xbitops_tpu_torch.models import llama, moe
from xbitops_tpu_torch.utils import structured
from xbitops_tpu_torch.utils.evaluate import sequence_nll

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

CYCLE = 8
CFG = dataclasses.replace(llama.LlamaConfig.tiny(vocab=256, seq=64), num_layers=2)
MOE_CFG = dataclasses.replace(moe.MoeConfig.tiny_moe(vocab=256, seq=64), num_layers=2)


def _quantize(root, params, cfg, write):
    """dense checkpoint dir -> quantize CLI -> packed dir."""
    dense_dir, packed_dir = root / "dense", root / "packed"
    write(params, cfg, str(dense_dir))
    np.save(root / "calib.npy", structured.structured_calib_tokens(cfg, CYCLE, n_rows=4,
                                                                   seq_len=48))
    assert main(["quantize", "--ckpt", str(dense_dir), "--out", str(packed_dir), "--bits", "4",
                 "--group-size", "64", "--seq-len", "48", "--calib-npy", str(root / "calib.npy"),
                 "--device", "cpu"]) == 0
    return dense_dir, packed_dir


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    params = structured.structured_dense_params(CFG, cycle=CYCLE, seed=0)
    return _quantize(tmp_path_factory.mktemp("e2e"), params, CFG,
                     structured.write_hf_dense_checkpoint)


@pytest.fixture(scope="module")
def moe_pipeline(tmp_path_factory):
    params = structured.structured_moe_params(MOE_CFG, cycle=CYCLE, seed=0)
    return _quantize(tmp_path_factory.mktemp("e2e_moe"), params, MOE_CFG,
                     structured.write_hf_mixtral_checkpoint)


def _held_out(cfg):
    return torch.from_numpy(structured.structured_calib_tokens(cfg, CYCLE, 4, 32, seed=7))


def _parity(dense_dir, packed_dir):
    dense, dcfg = load_autogptq(str(dense_dir), max_seq_len=64, device="cpu")
    quant = load_llama(str(packed_dir), dcfg, device="cpu")
    nll_d = float(sequence_nll(dense, _held_out(dcfg)).mean())
    nll_q = float(sequence_nll(quant, _held_out(dcfg)).mean())
    assert nll_d < 0.1, nll_d  # the dense source model walks its cycles
    assert nll_q < nll_d + 0.05, (nll_q, nll_d)
    return dcfg


def test_quantized_perplexity_parity(pipeline):
    _parity(*pipeline)


def test_moe_quantized_perplexity_parity(moe_pipeline):
    dcfg = _parity(*moe_pipeline)
    assert isinstance(dcfg, moe.MoeConfig) and dcfg.capacity_factor is None  # no-drop loads


@pytest.mark.parametrize("which,start", [("dense", 21), ("moe", 37)])
def test_generate_cli_continues_the_walk(pipeline, moe_pipeline, capsys, which, start):
    packed_dir = (pipeline if which == "dense" else moe_pipeline)[1]
    assert main(["generate", "--ckpt", str(packed_dir), "--prompt", str(start), "--max-tokens",
                 "8", "--slots", "1", "--max-seq-len", "32", "--device", "cpu"]) == 0
    want = [int(x) for x in structured.successor_stream(start, 8, CYCLE)]
    assert str(want) in capsys.readouterr().out, want


def test_spec_decode_real_acceptance(pipeline):
    """γ=4 n-gram drafts on the quantized model: plain greedy's tokens, and
    the draft accepts most of the time (a periodic walk is the prompt-lookup
    draft's own case)."""
    qmodel = load_llama(str(pipeline[1]), CFG, device="cpu")
    prompts = [list(range(16, 16 + CYCLE)) + list(range(16, 20)),
               list(range(40, 40 + CYCLE)) + list(range(40, 42))]
    reqs = [Request(prompt=p, max_new_tokens=16, id=i) for i, p in enumerate(prompts)]
    plain = Engine(qmodel, CFG, slots=2).generate([dataclasses.replace(r) for r in reqs])
    eng = Engine(qmodel, CFG, slots=2, spec_tokens=4)
    spec = eng.generate([dataclasses.replace(r) for r in reqs])
    assert [c.tokens for c in spec] == [c.tokens for c in plain]
    assert eng.spec_stats["drafted"] > 0
    assert eng.spec_stats["accepted"] / eng.spec_stats["drafted"] > 0.5, eng.spec_stats
    for c, p in zip(spec, prompts):
        assert c.tokens == list(structured.successor_stream(p[-1], len(c.tokens), CYCLE))


@pytest.mark.parametrize("which", ["dense", "mixtral"])
def test_checkpoint_writers_equal_jax(tmp_path, which):
    if which == "dense":
        cfg, jcfg = CFG, dataclasses.replace(jllama.LlamaConfig.tiny(vocab=256, seq=64),
                                             num_layers=2)
        ours = structured.structured_dense_params(cfg, cycle=CYCLE, seed=3)
        theirs = jstructured.structured_dense_params(jcfg, cycle=CYCLE, seed=3)
        structured.write_hf_dense_checkpoint(ours, cfg, str(tmp_path / "a"))
        jstructured.write_hf_dense_checkpoint(theirs, jcfg, str(tmp_path / "b"))
    else:
        cfg = MOE_CFG
        jcfg = dataclasses.replace(jmoe.MoeConfig.tiny_moe(vocab=256, seq=64), num_layers=2)
        ours = structured.structured_moe_params(cfg, cycle=CYCLE, seed=3)
        theirs = jstructured.structured_moe_params(jcfg, cycle=CYCLE, seed=3)
        structured.write_hf_mixtral_checkpoint(ours, cfg, str(tmp_path / "a"))
        jstructured.write_hf_mixtral_checkpoint(theirs, jcfg, str(tmp_path / "b"))
    a = st_np.load_file(str(tmp_path / "a" / "model.safetensors"))
    b = st_np.load_file(str(tmp_path / "b" / "model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (tmp_path / "a" / "config.json").read_text() == (tmp_path / "b" / "config.json").read_text()
    calib = structured.structured_calib_tokens(cfg, CYCLE, 3, 20, seed=4)
    np.testing.assert_array_equal(calib, jstructured.structured_calib_tokens(jcfg, CYCLE, 3, 20,
                                                                             seed=4))
