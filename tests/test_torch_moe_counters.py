"""The MoE layer's route counters (``models/moe.py``) on the tiny MoE model
(``MoeConfig.tiny_moe``, no-drop; no JAX reference): the counts of an
admission with padding rows and of a decode step with an inactive slot equal
a recount on the host from ``moe.route`` over the live rows; the engine's
``loop_stats`` keys add up to what its own counters say it ran; passing the
mask changes no logit, cache byte or served token; a dense model counts
nothing.  The case marked ``gpu`` holds a replayed burst's counts to the
eager ones on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_moe_counters.py -q
"""

import dataclasses

import pytest
import torch

from xbitops_tpu_torch.engine import Engine, Request
from xbitops_tpu_torch.models import llama, moe
from xbitops_tpu_torch.utils import synth

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CFG = dataclasses.replace(moe.MoeConfig.tiny_moe(seq=64), capacity_factor=None)
E, K = CFG.n_experts, CFG.experts_per_token


def _model(device="cpu"):
    return synth.random_moe_params(CFG, bits=4, group_size=128, device=device, seed=1)


def _requests(n=5, new=9):
    gen = torch.Generator().manual_seed(2)
    return [Request(prompt=torch.randint(0, CFG.vocab_size, (4 + 3 * i,), generator=gen).tolist(),
                    max_new_tokens=new + i % 3) for i in range(n)]


def _moe_inputs(model):
    """Record each MoE layer's input rows, a list a layer."""
    seen = [[] for _ in model.blocks]
    hooks = [b.moe.register_forward_pre_hook(lambda m, args, li=li: seen[li].append(args[0]))
             for li, b in enumerate(model.blocks)]
    return seen, hooks


def _recount(model, hx, live):
    """A layer's (routes to each expert, experts reached) over the rows of
    ``live``, from ``moe.route`` on the host."""
    load = torch.zeros(len(model.blocks), E, dtype=torch.int64)
    for li, b in enumerate(model.blocks):
        idx, _ = moe.route(hx[li].reshape(-1, CFG.hidden_size), b.moe.router, K)
        for e in idx[live.reshape(-1)].flatten().tolist():
            load[li, e] += 1
    return load


def test_counts_equal_a_host_recount():
    """An admission of three rows (one padded past its prompt, one an inert
    padding row) then a decode step with an inactive slot: each layer's
    counts of live routes by expert, experts reached, forwards and rows equal
    a recount from the router on the live rows alone."""
    model = _model()
    cache = llama.KVCache.init(CFG, 3, "cpu")
    seen, hooks = _moe_inputs(model)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, CFG.vocab_size, (3, 8), generator=gen)
    lens, slots = torch.tensor([5, 8, 0]), torch.tensor([0, 1, 3])  # row 2: slot out of range
    llama.prefill_slots(model, tokens, lens, slots, cache)
    step_tokens = torch.randint(0, CFG.vocab_size, (3,), generator=gen)
    llama.decode_step(model, step_tokens, cache, active=torch.tensor([True, True, False]))
    for h in hooks:
        h.remove()

    admit_live = torch.arange(8)[None] < lens[:, None]
    step_live = torch.tensor([True, True, False])[:, None]
    for phase, live, call in ((moe.ADMIT, admit_live, 0), (moe.DECODE, step_live, 1)):
        load = _recount(model, [s[call] for s in seen], live)
        assert load.sum() == K * int(live.sum()) * len(model.blocks)
        for li, b in enumerate(model.blocks):
            got = b.moe.route_counts[phase]
            assert torch.equal(got[:E], load[li]), (phase, li)
            assert torch.equal(got[E : 2 * E], (load[li] > 0).long()), (phase, li)
            assert got[2 * E :].tolist() == [1, E * live.numel()]
    st = moe.route_stats(model)
    want = _recount(model, [s[1] for s in seen], step_live)
    assert st["moe_routes"] == K * 2 * len(model.blocks)
    assert st["moe_admit_routes"] == K * 13 * len(model.blocks)
    assert st["moe_experts_hit"] == float((want > 0).sum())
    assert st["moe_layer_forwards"] == len(model.blocks)
    assert st["moe_expert_rows"] == E * 3 * len(model.blocks)
    assert st["moe_admit_expert_rows"] == E * 24 * len(model.blocks)
    busiest = (want.amax(dim=1).float() / want.sum(dim=1)).mean()
    assert st["moe_busiest_share"] == pytest.approx(float(busiest))
    moe.reset_route_counts(model)
    assert all(not t.any() for t in moe.route_counters(model))


def _engine(model, **kw):
    return Engine(model, CFG, slots=3, decode_burst=4, prefill_buckets=[8, 16], **kw)


def _loop_identities(eng, reqs):
    """The route counts an engine's call must give, from what it ran: every
    live row of every decode step (an active slot below S) takes k routes in
    each MoE layer, and every true prompt token at admission."""
    st, L = eng.loop_stats, len(eng.model.blocks)
    assert st["moe_routes"] == K * L * st["decode_slot_steps"] > 0
    assert st["moe_layer_forwards"] == L * st["decode_steps"]
    assert st["moe_expert_rows"] == E * eng.slots * st["moe_layer_forwards"]
    assert st["moe_admit_routes"] == K * L * sum(len(r.prompt) for r in reqs)
    assert 0 < st["moe_experts_hit"] <= E * st["moe_layer_forwards"]
    assert 1 / E <= st["moe_busiest_share"] <= 1


def test_mask_changes_no_served_token(monkeypatch):
    """The engine serves the same tokens with the counters fed and with the
    mask withheld (nothing counted); a decode step gives the same logits and
    cache bits either way."""
    model = _model()
    reqs = _requests()
    eng = _engine(model)
    counted = eng.generate(reqs)
    _loop_identities(eng, reqs)
    cache = eng.cache
    step = [cache.k.clone(), cache.v.clone(), cache.lengths.clone()]
    tokens = torch.tensor([3, 7, 11])
    logits, _ = llama.decode_step(model, tokens, cache, active=torch.tensor([True, False, True]))

    forward = moe.MoeFFN.forward
    monkeypatch.setattr(moe.MoeFFN, "forward",
                        lambda self, hx, use_kernel=True, a8=False, live=None, admit=False:
                        forward(self, hx, use_kernel, a8))
    plain = _engine(model)
    withheld = plain.generate(reqs)
    assert [c.tokens for c in withheld] == [c.tokens for c in counted]
    assert all(plain.loop_stats[k] == 0 for k in moe.ROUTE_STATS)
    again = llama.KVCache.init(CFG, 3, "cpu")
    for dst, src in zip((again.k, again.v, again.lengths), step):
        dst.copy_(src)
    logits2, _ = llama.decode_step(model, tokens, again, active=torch.tensor([True, False, True]))
    assert torch.equal(logits, logits2)
    assert torch.equal(cache.k, again.k) and torch.equal(cache.v, again.v)


def test_dense_model_counts_nothing():
    cfg = llama.LlamaConfig.tiny(seq=64)
    model = llama.init_params(torch.Generator().manual_seed(0), cfg, bits=4, group_size=32)
    eng = Engine(model, cfg, slots=2, decode_burst=2, prefill_buckets=[8])
    eng.generate([Request(prompt=[5, 9, 2], max_new_tokens=4)])
    assert not moe.route_counters(model) and moe.route_stats(model) == {}
    assert not any(k.startswith("moe_") for k in eng.loop_stats)
    assert all(eng.loop_stats[k] == 0 for k in moe.ROUTE_STATS)


@pytest.mark.gpu
def test_replayed_bursts_count_as_eager():
    """On the card each burst is a replay of one captured graph, which counts
    every step it replays (and not the capture's warm-up): the counts equal
    the eager engine's on the same requests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode bursts replay as CUDA graphs only there")
    dev = torch.device("cuda:0")
    reqs = _requests(n=6)
    model = _model(dev)
    eager = _engine(model)
    eager._eager = True
    want = eager.generate(reqs)
    eng = _engine(model)
    got = eng.generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert eng.loop_stats["graph_captures"] == 1
    assert eng.loop_stats["graph_replays"] == eng.loop_stats["decode_steps"] / 4
    _loop_identities(eng, reqs)
    assert {k: eng.loop_stats[k] for k in moe.ROUTE_STATS} == {
        k: eager.loop_stats[k] for k in moe.ROUTE_STATS}
