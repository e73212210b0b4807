"""The port's HTTP endpoint (``engine/server.py``), mirroring
``tests/test_server.py``: health, a completion with its usage, concurrent
clients micro-batched into one wave, bad requests as 400.  On the same tiny
weights (the JAX package's ``init_params``, carried across by
``io/convert.py``) the greedy tokens over HTTP equal the JAX endpoint's and
the port engine's own.  An engine error reaches every waiter as a 500; with
``max_restarts`` the endpoint answers as if no error had happened."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from xbitops_tpu.engine.engine import Engine as JEngine
from xbitops_tpu.engine.server import ServingEndpoint as JServingEndpoint
from xbitops_tpu.models import llama as jllama
from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.engine.server import ServingEndpoint
from xbitops_tpu_torch.io.convert import params_from_numpy
from xbitops_tpu_torch.models import llama

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
CFG = llama.LlamaConfig.tiny()
PROMPTS = [[5, 9, 2], [3, 1], [7, 7, 7, 7, 1, 2], [200, 4, 17, 33]]


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.PRNGKey(0), JCFG, bits=4, group_size=32)


@pytest.fixture(scope="module")
def model(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _serve(eng, **kw):
    ep = ServingEndpoint(eng, port=0, batch_window_s=0.05, **kw)
    ep.start()
    return ep


@pytest.fixture(scope="module")
def endpoint(model):
    ep = _serve(Engine(model, CFG, slots=2, prefill_buckets=[8]))
    yield ep
    ep.shutdown()


@pytest.fixture(scope="module")
def jax_tokens(jparams):
    """The JAX endpoint's greedy tokens for PROMPTS (4 tokens each)."""
    ep = JServingEndpoint(JEngine(jparams, JCFG, slots=2, prefill_buckets=[8]), port=0,
                          batch_window_s=0.05)
    ep.start()
    try:
        return [_post(ep.port, {"prompt": p, "max_tokens": 4})[1]["choices"][0]["tokens"]
                for p in PROMPTS]
    finally:
        ep.shutdown()


def _post(port, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(endpoint):
    with urllib.request.urlopen(f"http://127.0.0.1:{endpoint.port}/health", timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["status"] == "ok"
    assert body["slots"] == 2 and body["max_seq_len"] == CFG.max_seq_len
    assert body["kv_quant"] is False


def test_completion_matches_engine(endpoint, model):
    code, body = _post(endpoint.port, {"prompt": [5, 9, 2], "max_tokens": 4})
    assert code == 200, body
    choice = body["choices"][0]
    assert len(choice["tokens"]) == 4 and choice["finish_reason"] == "length"
    assert body["usage"] == {"prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}
    code2, body2 = _post(endpoint.port, {"prompt": [5, 9, 2], "max_tokens": 4})
    assert code2 == 200 and body2["choices"][0]["tokens"] == choice["tokens"]
    want = Engine(model, CFG, slots=2, prefill_buckets=[8]).generate(
        [Request(prompt=[5, 9, 2], max_new_tokens=4)])
    assert choice["tokens"] == want[0].tokens


def test_tokens_equal_jax_endpoint(endpoint, jax_tokens):
    got = [_post(endpoint.port, {"prompt": p, "max_tokens": 4})[1]["choices"][0]["tokens"]
           for p in PROMPTS]
    assert got == jax_tokens


def test_concurrent_clients_batch(endpoint, jax_tokens):
    results = {}

    def client(i):
        results[i] = _post(endpoint.port, {"prompt": PROMPTS[i], "max_tokens": 4})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert all(code == 200 for code, _ in results.values()), results
    assert [results[i][1]["choices"][0]["tokens"] for i in range(len(PROMPTS))] == jax_tokens


def test_bad_requests(endpoint):
    code, body = _post(endpoint.port, {"prompt": "text needs a tokenizer"})
    assert code == 400 and "tokenizer" in body["error"]
    code, _ = _post(endpoint.port, {"prompt": [1.5]})
    assert code == 400
    with urllib.request.urlopen(f"http://127.0.0.1:{endpoint.port}/health", timeout=30):
        pass
    req = urllib.request.Request(f"http://127.0.0.1:{endpoint.port}/v2/none", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 404


def _faulty(eng):
    calls = []

    def hook():
        calls.append(1)
        if len(calls) == 2:
            raise torch.AcceleratorError("injected device error")
    eng._fault_hook = hook
    return eng


def test_engine_error_reaches_the_waiter(model):
    ep = _serve(_faulty(Engine(model, CFG, slots=2, prefill_buckets=[8])))
    try:
        code, body = _post(ep.port, {"prompt": [5, 9, 2], "max_tokens": 4})
        assert code == 500 and "AcceleratorError" in body["error"]
    finally:
        ep.shutdown()


def test_restarting_engine_answers_as_if_clean(model, jax_tokens):
    eng = _faulty(Engine(model, CFG, slots=2, prefill_buckets=[8], max_restarts=1))
    ep = _serve(eng)
    try:
        code, body = _post(ep.port, {"prompt": PROMPTS[0], "max_tokens": 4})
        assert code == 200 and body["choices"][0]["tokens"] == jax_tokens[0]
        assert body["usage"]["prompt_tokens"] == len(PROMPTS[0]) and eng.restarts == 1
    finally:
        ep.shutdown()
