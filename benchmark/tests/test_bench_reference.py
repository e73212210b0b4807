"""The plain reference against the port on tiny Mistral- and Mixtral-shaped
models on the CPU, the reference's unpacking of the packed words, the
controls, and what the reference and the harness import."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.core import program, synth
from benchmark.reference.llama import Reference, fp8_rows, int4_rows, unpack
from conftest import DATA, REPO


def cfg(name):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.mark.parametrize("experts", [0, 3])
@pytest.mark.parametrize("K", [256, 512, 4096])
def test_unpack_equals_the_ports_dequant(K, experts):
    from xbitops_tpu_torch.ops.dequant import dequant_qtensor

    p = synth.packed(5, f"w{K}", K, 64, 128, "cpu", experts=experts)
    qt = program.qtensor(p)
    for e in range(max(1, experts)):
        want = dequant_qtensor(qt.layer(e) if experts else qt, out_dtype=torch.float32)
        assert torch.equal(unpack(p, e if experts else None), want)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-moe"])
def test_reference_agrees_with_the_port(name):
    """Prefill logits of the port's plain path (bf16 activations) against the
    float32 reference: within a tenth of the logits' spread at most positions (a bf16 forward of 2 layers), and
    the controls (float8 activations, an int4 cache) further off."""
    from xbitops_tpu_torch.models import llama

    c = cfg(name)
    model, mcfg = program.build_model(c, 7, "cpu")
    toks = torch.randint(0, c["vocab_size"], (1, 100), generator=torch.Generator().manual_seed(0))
    cache = llama.KVCache.init(mcfg, 1, "cpu")
    port = llama.prefill(model, toks, cache)[0][0].float()
    seq, rows = [toks[0].tolist()], [range(100)]
    ref = Reference(c, 7, "cpu").logits(seq, rows)[0]
    err = (port - ref).abs().amax(dim=-1)
    assert float(err.median()) < 0.1 * float(ref.std())
    assert float((port.argmax(-1) == ref.argmax(-1)).float().mean()) >= 0.95
    for rounding in (dict(act=fp8_rows), dict(kv=int4_rows)):
        ctl = Reference(c, 7, "cpu", **rounding).logits(seq, rows)[0]
        assert float((ctl - ref).abs().amax(dim=-1).median()) > 2 * float(err.median())


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=REPO, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.llama, benchmark.core.judge")
    assert not mods & {"xbitops_tpu_torch", "xbitops_tpu", "jax", "jaxlib", "flax"}


def test_the_harness_imports_no_jax():
    """What run.py imports, the drivers and every metric with them: no
    top-level name is a JAX one (compared whole: the port's name begins with
    the JAX package's)."""
    mods = _loaded("import benchmark.run, benchmark.control, benchmark.drivers.endpoint, "
                   "benchmark.drivers.generate, benchmark.core.program\n"
                   "import pkgutil, importlib, benchmark.metrics as m\n"
                   "[importlib.import_module('benchmark.metrics.' + i.name) "
                   "for i in pkgutil.iter_modules(m.__path__)]\n"
                   "from benchmark.core import program\n"
                   "import xbitops_tpu_torch.engine.server, xbitops_tpu_torch.models.moe")
    assert "xbitops_tpu_torch" in mods
    assert not mods & {"xbitops_tpu", "jax", "jaxlib", "flax"}
