"""The ranks of the port's tensor- and expert-parallel tests: each function
below runs in every process of a gloo world that ``run`` spawns, on the CPU
with one torch thread a rank.  They import no ``jax``: the pytest process
computes the JAX results and hands the inputs over as files (numpy arrays,
JSON, and packed checkpoint directories written by the JAX package), and the
ranks write their results beside them for the tests to read."""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from xbitops_tpu_torch.parallel import multihost


# A world that has not ended by then is ended (a collective waits 600 s for a
# dead peer): 10x the longest world of an 8-core run of the suite at -n 6
# (engine_tp2, 15 s).
WORLD_DEADLINE_S = 150.0


def run(case: str, world: int, d: Path) -> None:
    """Run ``case(rank, d)`` on every rank of a new ``world``-rank gloo world,
    and raise ``TimeoutError`` where the world has not ended within
    ``WORLD_DEADLINE_S`` seconds (its ranks are ended)."""
    deadline_s = WORLD_DEADLINE_S
    before = set(multiprocessing.active_children())
    expired = threading.Event()

    def end_world():
        expired.set()
        for p in set(multiprocessing.active_children()) - before:
            p.terminate()

    timer = threading.Timer(deadline_s, end_world)
    timer.start()
    try:
        multihost.spawn(_entry, world, args=(case, str(d)), backend="gloo", device="cpu")
    except (torch.multiprocessing.ProcessExitedException,
            torch.multiprocessing.ProcessRaisedException) as e:
        if expired.is_set():
            raise TimeoutError(f"rank case {case!r} ({world} ranks) did not end within "
                               f"{deadline_s} s") from e
        raise
    finally:
        timer.cancel()


def _entry(rank: int, case: str, d: str) -> None:
    if "jax" in sys.modules:
        raise RuntimeError("a test rank imported jax")
    globals()[case](rank, Path(d))


def _save(d: Path, name: str, rank: int, **arrays) -> None:
    np.savez(d / f"{name}_rank{rank}.npz", **{k: _np(v) for k, v in arrays.items()})


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.is_floating_point() else t.detach().numpy()
    return np.asarray(t)


def _raises(fn) -> str:
    """The message of the ValueError ``fn`` raises ("" where it raises none)."""
    try:
        fn()
    except ValueError as e:
        return str(e) or "ValueError"
    return ""


# --- the tensor-parallel matmuls (tests/test_torch_tp.py) ---


def tp_ops(rank: int, d: Path) -> None:
    from xbitops_tpu_torch.ops.quantize import quantize_array
    from xbitops_tpu_torch.parallel import tp
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    inp = np.load(d / "inputs.npz")
    t = {k: torch.from_numpy(inp[k]) for k in inp.files}
    mesh = make_mesh()
    n, r = mesh.shape["model"], mesh.index("model")
    out = {}

    qt = quantize_array(t["col_w"], 4, 128)
    local = tp.local_qtensor(qt, mesh, col_axis="model")
    out["col"] = tp.column_parallel_qmatmul(t["col_a"], local, mesh, out_dtype=torch.float32,
                                            gather=True, precise=True)
    out["col_sharded"] = tp.column_parallel_qmatmul(t["col_a"][:1], local, mesh,
                                                    out_dtype=torch.float32, precise=True)

    qt = tp.local_qtensor(quantize_array(t["row_w"], 4, 128, row_shards=n), mesh,
                          row_axis="model")
    K = t["row_a"].shape[1] // n
    a_local = t["row_a"][:, r * K : (r + 1) * K]
    for red in ("psum", "reduce_scatter"):
        out[f"row_{red}"] = tp.row_parallel_qmatmul(a_local, qt, mesh, out_dtype=torch.float32,
                                                    reduce=red, precise=True)

    qt = quantize_array(t["mis_w"], 4, 128, row_shards=n)
    out["mis_group"] = torch.tensor(qt.group_size)
    K = t["mis_a"].shape[1] // n
    out["mis"] = tp.row_parallel_qmatmul(
        t["mis_a"][:, r * K : (r + 1) * K], tp.local_qtensor(qt, mesh, row_axis="model"), mesh,
        out_dtype=torch.float32, precise=True)

    q1 = tp.local_qtensor(quantize_array(t["meg_w1"], 4, 128), mesh, col_axis="model")
    q2 = tp.local_qtensor(quantize_array(t["meg_w2"], 4, 128, row_shards=n), mesh,
                          row_axis="model")
    h = tp.column_parallel_qmatmul(t["meg_a"], q1, mesh, out_dtype=torch.float32, precise=True)
    out["meg"] = tp.row_parallel_qmatmul(h, q2, mesh, out_dtype=torch.float32, precise=True)

    qt = quantize_array(t["act_w"], 4, 64, row_shards=n, act_order=True)
    out["act_perm_shape"] = torch.tensor(qt.perm.shape)
    K = t["act_a"].shape[1] // n
    out["act"] = tp.row_parallel_qmatmul(
        t["act_a"][:, r * K : (r + 1) * K], tp.local_qtensor(qt, mesh, row_axis="model"), mesh,
        out_dtype=torch.float32, precise=True)

    plain = quantize_array(t["val_w"], 4, 128)
    narrow = quantize_array(t["val_narrow"], 4, 128)
    over = quantize_array(t["val_over"], 4, 64, row_shards=2 * n)
    msgs = [_raises(lambda: tp.local_qtensor(plain, mesh, row_axis="model")),
            _raises(lambda: tp.local_qtensor(narrow, mesh, col_axis="model")),
            _raises(lambda: tp.local_qtensor(over, mesh, row_axis="model"))]
    (d / f"val_rank{rank}.json").write_text(json.dumps(msgs))
    _save(d, "tp", rank, **out)


# --- the model and the cache (tests/test_torch_model_tp.py), the engine
# (tests/test_torch_engine_tp.py) ---


def _tiny(**kw):
    from xbitops_tpu_torch.models import llama

    return llama.LlamaConfig.tiny(**kw)


def model_tp2(rank: int, d: Path) -> None:
    """Logits of the sharded prefill and decode step of the JAX package's tp=2
    trees, and of ``pack_for_tp`` of the port's own tp=1 models."""
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import model_tp
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    cfg = _tiny()
    inp = np.load(d / "inputs.npz")
    mesh = make_mesh((1, 2))
    out = {}
    for name in ("q8", "fused", "stacked", "act"):
        full = load_llama(str(d / name), cfg, "cpu", tp=2)
        m = model_tp.shard_params(full, mesh)
        tokens = torch.from_numpy(inp[f"{name}_tokens"]).long()
        cache = llama.KVCache.init(m.cfg, tokens.shape[0], "cpu")
        logits, cache = model_tp.tp_prefill(m, cfg, mesh, tokens, cache)
        out[f"{name}_prefill"] = logits
        nxt = torch.from_numpy(inp[f"{name}_next"]).int()
        out[f"{name}_decode"], _ = model_tp.tp_decode_step(m, cfg, mesh, nxt, cache)
        out[f"{name}_lengths"] = cache.lengths.clone()
    # the one-slot forms on the q8 tree: a prompt of 6 into slot 1, one of 12
    # into slot 0 in chunks of 8
    m = model_tp.shard_params(load_llama(str(d / "q8"), cfg, "cpu", tp=2), mesh)
    out["slot"], _ = model_tp.tp_prefill_slot(m, cfg, mesh, torch.from_numpy(inp["slot_tokens"]),
                                              6, 1, llama.KVCache.init(m.cfg, 2, "cpu"))
    cache, tokens = llama.KVCache.init(m.cfg, 2, "cpu"), torch.from_numpy(inp["chunk_tokens"])
    for start in (0, 8):
        out["slot_chunk"], cache = model_tp.tp_prefill_slot_chunk(
            m, cfg, mesh, tokens[start:start + 8], start, 12, 0, cache, reset=start == 0)
    # pack_for_tp of the port's own tp=1 models against those models
    tokens = torch.from_numpy(inp["q8_tokens"]).long()
    for name, kw in PACKED.items():
        one = llama.init_params(torch.Generator().manual_seed(5), cfg, bits=4, group_size=32,
                                **kw)
        out[f"pack_{name}_perm"] = torch.tensor(
            (one.blocks[0].wqkv if kw.get("fuse", True) else one.blocks[0].wq).perm is not None)
        out[f"pack_{name}_one"], _ = llama.prefill(
            one, tokens, llama.KVCache.init(cfg, tokens.shape[0], "cpu"))
        m = model_tp.shard_params(model_tp.pack_for_tp(one, 2), mesh)
        out[f"pack_{name}_tp"], _ = model_tp.tp_prefill(
            m, cfg, mesh, tokens, llama.KVCache.init(m.cfg, tokens.shape[0], "cpu"))
    _save(d, "model", rank, **out)


# the port's tp=1 models that model_tp2 packs for tp=2: split, fused, fused act-order
PACKED = {"split": dict(fuse=False), "fused": {}, "act": dict(act_order=True)}


def engine_tp2(rank: int, d: Path) -> None:
    """Greedy tokens of ``Engine(mesh=)`` on three cache forms, with
    ``kv_quant=None``, with speculative decoding (``tp_spec_verify_step``'s
    forward) and with chunked admission; a restart whose fault fires on every
    rank at the same burst."""
    from xbitops_tpu_torch.engine import Engine, Request
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    cfg = _tiny()
    mesh = make_mesh((1, 2))
    out = {}
    full = load_llama(str(d / "q8"), cfg, "cpu", tp=2)
    prompts = json.loads((d / "prompts.json").read_text())
    stats = {}
    for kind, kw in (("bf16", dict(kv_quant=False)), ("int8", dict(kv_quant=True)),
                     ("paged", dict(paged=True, page_size=16)), ("auto", {}),
                     ("spec", dict(kv_quant=False, spec_tokens=2)),
                     ("chunked", dict(kv_quant=False, prefill_chunk=8))):
        ecfg = _tiny(seq=1024) if kind == "auto" else cfg  # the long cache int8 would take
        model = full if kind != "auto" else load_llama(str(d / "q8"), ecfg, "cpu", tp=2)
        eng = Engine(model, ecfg, slots=2, mesh=mesh, **kw)
        done = eng.generate([Request(prompt=p, max_new_tokens=6) for p in prompts])
        out[f"engine_{kind}"] = np.asarray([c.tokens for c in done])
        stats[kind] = dict(eng.loop_stats, kv_quant=eng.kv_quant,
                           cache_heads=eng.cache.k.shape[2], spec=eng.spec_stats)
    seen = []

    def fault():  # every rank at its second burst, as the reference injects it
        seen.append(1)
        if len(seen) == 2:
            raise torch.AcceleratorError("injected device error")

    eng = Engine(full, cfg, slots=2, mesh=mesh, kv_quant=False, max_restarts=1)
    eng._fault_hook = fault
    done = eng.generate([Request(prompt=p, max_new_tokens=6) for p in prompts])
    out["engine_restart"] = np.asarray([c.tokens for c in done])
    stats["restart"] = dict(eng.loop_stats, restarts=eng.restarts)
    if rank == 0:
        (d / "stats.json").write_text(json.dumps(stats))
    _save(d, "engine", rank, **out)


def model_tp4(rank: int, d: Path) -> None:
    """A dp x tp = 2 x 2 mesh (``make_pod_mesh(tp=2)``): the data replicas take
    their rows, the logits are gathered.  Expert parallelism of the tiny MoE
    model over 4 ranks against the same model on one rank."""
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.models import llama, moe
    from xbitops_tpu_torch.parallel import model_tp
    from xbitops_tpu_torch.parallel.mesh import make_mesh
    from xbitops_tpu_torch.parallel.multihost import make_pod_mesh

    inp = np.load(d / "inputs.npz")
    out = {}
    mesh = make_pod_mesh(tp=2)
    out["pod_shape"] = torch.tensor(mesh.sizes)
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                            num_layers=1, num_heads=4, num_kv_heads=4, head_dim=128,
                            max_seq_len=16)
    m = model_tp.shard_params(load_llama(str(d / "pod"), cfg, "cpu", tp=2), mesh)
    tokens = torch.from_numpy(inp["pod_tokens"]).long()
    cache = model_tp.shard_cache(llama.KVCache.init(cfg, 4, "cpu"), mesh, "model", "data")
    out["pod_cache_shape"] = torch.tensor(cache.k.shape)
    out["pod_prefill"], cache = model_tp.tp_prefill(m, cfg, mesh, tokens, cache,
                                                    data_axis="data")
    nxt = torch.from_numpy(inp["pod_next"]).int()
    out["pod_decode"], _ = model_tp.tp_decode_step(m, cfg, mesh, nxt, cache, data_axis="data")

    mcfg = moe.MoeConfig.tiny_moe()
    full = load_llama(str(d / "moe"), mcfg, "cpu")
    emesh = make_mesh((4,), ("expert",))
    ep = moe.shard_experts(full, emesh)
    out["ep_experts"] = torch.tensor(ep.blocks[0].moe.w_experts_gateup.qtensor.planes[0].shape[0])
    tokens = torch.from_numpy(inp["moe_tokens"]).long()
    B, T = tokens.shape
    lens, slots = torch.full((B,), T), torch.arange(B)
    for label, mdl, step, pre in (
            ("one", full, lambda m, t, c: llama.decode_step(m, t, c),
             lambda m, *a: llama.prefill_slots(m, *a)),
            ("ep", ep, lambda m, t, c: moe.ep_decode_step(m, mcfg, emesh, t, c),
             lambda m, *a: moe.ep_prefill_slots(m, mcfg, emesh, *a))):
        cache = llama.KVCache.init(mcfg, B, "cpu")
        logits, cache = pre(mdl, tokens, lens, slots, cache)
        out[f"{label}_prefill"] = logits
        out[f"{label}_k"] = cache.k
        nxt = torch.from_numpy(inp["moe_next"]).int()
        out[f"{label}_decode"], _ = step(mdl, nxt, cache)
    _save(d, "model4", rank, **out)


# --- loaders (tests/test_torch_tp_io.py) ---


def io_tp2(rank: int, d: Path) -> None:
    """The sharded prefill of the desc_act AutoGPTQ checkpoint loaded with
    ``tp=2`` (gathered o_proj, folded down_proj), and of the tp=2 packed
    directories written by the JAX package and by the port."""
    from xbitops_tpu_torch.io import load_autogptq
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import model_tp
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    inp = np.load(d / "inputs.npz")
    mesh = make_mesh((1, 2))
    out = {}
    full, cfg = load_autogptq(str(d / "desc_ckpt"), tp=2, max_seq_len=32, device="cpu")
    roles = {k: getattr(model_tp.shard_params(full, mesh).blocks[0], k).role.kind
             for k in ("wo", "w_down")}
    tokens = torch.from_numpy(inp["desc_tokens"]).long()
    for name, model in (("desc", full),
                        ("jax_dir", load_llama(str(d / "jax_tp2"), cfg, "cpu", tp=2)),
                        ("port_dir", load_llama(str(d / "port_tp2"), cfg, "cpu", tp=2))):
        m = model_tp.shard_params(model, mesh)
        cache = llama.KVCache.init(m.cfg, tokens.shape[0], "cpu")
        out[name], _ = model_tp.tp_prefill(m, cfg, mesh, tokens, cache)
    if rank == 0:
        (d / "roles.json").write_text(json.dumps(roles))
    _save(d, "io", rank, **out)


# --- pipeline parallelism (tests/test_torch_pp.py) ---


def _cache(inp, prefix: str = ""):
    """A whole cache from the arrays the JAX package prefilled: bf16 rows
    (or int32 words and bf16 scales) and lengths."""
    from xbitops_tpu_torch.models import llama

    t = lambda k: torch.from_numpy(inp[prefix + k])
    scales = {}
    if prefix + "k_scale" in inp.files:
        scales = dict(k_scale=t("k_scale").to(torch.bfloat16),
                      v_scale=t("v_scale").to(torch.bfloat16))
        k, v = t("k"), t("v")
    else:
        k, v = t("k").to(torch.bfloat16), t("v").to(torch.bfloat16)
    return llama.KVCache(k=k, v=v, lengths=t("lengths").int(), **scales)


def _whole(cache, mesh, axis: str = "pipe"):
    """The stages' caches put back together along the layer axis."""
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel.mesh import all_gather

    g = lambda t: None if t is None else all_gather(t, mesh, axis, dim=0)
    return llama.KVCache(k=g(cache.k), v=g(cache.v), lengths=cache.lengths,
                         k_scale=g(cache.k_scale), v_scale=g(cache.v_scale))


def pp2(rank: int, d: Path) -> None:
    """Decode steps, bursts and admission at pp=2 (each rank one of the tiny
    model's 2 layers) from the JAX package's prefilled caches; each case also
    through the port's one-rank path, and the raises."""
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import pp
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    cfg = _tiny()
    inp = np.load(d / "inputs.npz")
    mesh = make_mesh((2,), ("pipe",))
    full = load_llama(str(d / "p1"), cfg, "cpu")
    stage = pp.stage_model(full, mesh)
    out = {"stage_layers": torch.tensor(len(stage.blocks))}
    toks = torch.from_numpy(inp["toks"]).int()

    for name, prefix, active in (("dec", "", None), ("mask", "", [True, False, True, False]),
                                 ("int8", "q_", None)):
        act = None if active is None else torch.tensor(active)
        tok, want = torch.from_numpy(inp[prefix + "toks"]).int(), _cache(inp, prefix)
        logits, cache = pp.pp_decode_step(stage, cfg, mesh, tok, pp.stage_cache(want, mesh),
                                          active=act)
        one, want = llama.decode_step(full, tok, want, active=act)
        got = _whole(cache, mesh)
        out[f"{name}_logits"], out[f"{name}_one"] = logits, one
        out[f"{name}_lengths"], out[f"{name}_k"] = got.lengths, got.k
        fields = ("k", "v", "k_scale", "v_scale") if prefix else ("k", "v")
        out[f"{name}_same_as_one"] = torch.tensor(
            all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields)
            and torch.equal(got.lengths, want.lengths))

    # bursts, against n pp_decode_steps of the port; the second with an
    # inactive slot and one a position from the capacity
    S = cfg.max_seq_len
    for name, n, active, near_full in (("burst", 5, None, False),
                                       ("burst_mask", 4, [True, True, False, True], True)):
        act = None if active is None else torch.tensor(active)
        whole = _cache(inp)
        if near_full:
            whole.lengths[3] = S - 1
        tokens, cache = pp.pp_decode_burst(stage, cfg, mesh, toks, pp.stage_cache(whole, mesh), n,
                                           active=act)
        seq_cache, cur, seq = pp.stage_cache(whole, mesh), toks, []
        for _ in range(n):
            logits, seq_cache = pp.pp_decode_step(stage, cfg, mesh, cur, seq_cache, active=act)
            cur = logits.argmax(-1).int()
            if act is not None:
                cur = torch.where(act, cur, 0)
            seq.append(cur)
        out[f"{name}_tokens"], out[f"{name}_seq"] = tokens, torch.stack(seq)
        got = _whole(cache, mesh)
        out[f"{name}_lengths"], out[f"{name}_k"] = got.lengths, got.k
        out[f"{name}_cache_same"] = torch.tensor(
            torch.equal(cache.k, seq_cache.k) and torch.equal(cache.v, seq_cache.v)
            and torch.equal(cache.lengths, seq_cache.lengths))

    # admission into fresh slots, then one ordinary decode step from the gathered cache
    tokens, lens = torch.from_numpy(inp["pre_tokens"]).long(), torch.from_numpy(inp["pre_lens"])
    B = tokens.shape[0]
    logits, cache = pp.pp_prefill_slots(stage, cfg, mesh, tokens, lens,
                                        llama.KVCache.init(stage.cfg, B, "cpu"))
    one, one_cache = llama.prefill_slots(full, tokens, lens, torch.arange(B),
                                         llama.KVCache.init(cfg, B, "cpu"))
    got = _whole(cache, mesh)
    out.update(pre_logits=logits, pre_one=one, pre_lengths=got.lengths.clone(), pre_k=got.k,
               pre_same_as_one=torch.tensor(torch.equal(got.k, one_cache.k)
                                            and torch.equal(got.v, one_cache.v)))
    nxt = logits.argmax(-1).int()
    out["pre_decode"] = llama.decode_step(full, nxt, got)[0]
    out["pre_decode_one"] = llama.decode_step(full, nxt, one_cache)[0]

    cache = llama.KVCache.init(stage.cfg, 4, "cpu")
    paged = llama.KVCache.init_paged(stage.cfg, 4, 8, 16, device="cpu")
    msgs = [_raises(lambda: pp.pp_decode_step(stage, cfg, mesh, toks[:3], cache)),
            _raises(lambda: pp.pp_decode_step(stage, cfg, mesh, toks, paged)),
            _raises(lambda: pp.pp_decode_step(full, cfg, mesh, toks, cache)),
            _raises(lambda: pp.stage_model(llama.init_params(
                torch.Generator().manual_seed(0), _tiny(), bits=4, group_size=32).with_config(
                dataclasses.replace(cfg, num_layers=1)), mesh))]
    (d / f"raises_rank{rank}.json").write_text(json.dumps(msgs))
    _save(d, "pp2", rank, **out)


def pp4(rank: int, d: Path) -> None:
    """A (pipe, model) = 2 x 2 mesh: the JAX package's tp=2 tree, each rank
    one layer's shard; a decode step and a burst from the prefilled cache."""
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.parallel import pp
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    cfg = _tiny()
    inp = np.load(d / "inputs.npz")
    mesh = make_mesh((2, 2), ("pipe", "model"))
    stage = pp.stage_model(load_llama(str(d / "p2"), cfg, "cpu", tp=2), mesh, tp_axis="model")
    toks = torch.from_numpy(inp["toks"]).int()
    out = {"heads": torch.tensor(stage.cfg.num_heads)}
    whole = _cache(inp)
    out["logits"], cache = pp.pp_decode_step(stage, cfg, mesh, toks,
                                             pp.stage_cache(whole, mesh, tp_axis="model"),
                                             tp_axis="model")
    out["k"], out["lengths"] = cache.k, cache.lengths
    tokens, burst = pp.pp_decode_burst(stage, cfg, mesh, toks,
                                       pp.stage_cache(whole, mesh, tp_axis="model"), 3,
                                       tp_axis="model")
    seq_cache, cur, seq = pp.stage_cache(whole, mesh, tp_axis="model"), toks, []
    for _ in range(3):
        logits, seq_cache = pp.pp_decode_step(stage, cfg, mesh, cur, seq_cache, tp_axis="model")
        cur = logits.argmax(-1).int()
        seq.append(cur)
    out["burst_tokens"], out["burst_seq"] = tokens, torch.stack(seq)
    out["burst_cache_same"] = torch.tensor(torch.equal(burst.k, seq_cache.k))
    _save(d, "pp4", rank, **out)


# --- sequence parallelism (tests/test_torch_seqpar.py) ---

# name -> (packed directory, config options, tp)
SP_TREES = {"plain": ("sp_plain", {}, 1), "stacked": ("sp_stacked", {}, 1),
            "window": ("sp_window", dict(sliding_window=8), 1), "tp": ("sp_tp", {}, 2)}


def seq4(rank: int, d: Path) -> None:
    """Ring attention at sp=4 on chunks of the same f32 inputs, and
    ``sp_prefill`` of the JAX package's trees at sp=4 and at (seq, model) =
    2 x 2, each followed by one ordinary greedy decode step; the raises."""
    from xbitops_tpu_torch.io.checkpoint import load_llama
    from xbitops_tpu_torch.models import llama
    from xbitops_tpu_torch.parallel import model_tp, seqpar
    from xbitops_tpu_torch.parallel.mesh import make_mesh

    inp = np.load(d / "inputs.npz")
    t = lambda k: torch.from_numpy(inp[k])
    seq = make_mesh((4,), ("seq",))
    sp_tp = make_mesh((2, 2), ("seq", "model"))
    c = seq.index("seq")
    out = {}
    for name in ("rep1", "rep2", "reversed", "window"):
        q, k, v, qp, kp = (t(f"{name}_{x}") for x in ("q", "k", "v", "q_pos", "kv_pos"))
        n = q.shape[1] // 4
        part = lambda x: x[:, c * n:(c + 1) * n]
        window = int(inp[f"{name}_window"]) or None
        out[f"ring_{name}"] = seqpar.ring_attention(part(q), part(k), part(v), part(qp),
                                                    part(kp), seq, window=window)
    for name, (path, kw, tp) in SP_TREES.items():
        cfg = dataclasses.replace(_tiny(), **kw)
        full = load_llama(str(d / path), cfg, "cpu", tp=tp)
        mesh = sp_tp if tp > 1 else seq
        model = model_tp.shard_params(full, mesh) if tp > 1 else full
        tokens = t(f"{name}_tokens").long()
        B = tokens.shape[0]
        logits, cache = seqpar.sp_prefill(model, cfg, mesh, tokens,
                                          llama.KVCache.init(model.cfg, B, "cpu"),
                                          tp_axis="model" if tp > 1 else None)
        out[f"{name}_logits"], out[f"{name}_k"], out[f"{name}_v"] = logits, cache.k, cache.v
        out[f"{name}_lengths"] = cache.lengths.clone()
        nxt = logits.argmax(-1).int()
        if tp > 1:
            out[f"{name}_decode"] = model_tp.tp_decode_step(model, cfg, mesh, nxt, cache)[0]
        else:
            out[f"{name}_decode"] = llama.decode_step(model, nxt, cache)[0]
            one, one_cache = llama.prefill(model, tokens, llama.KVCache.init(cfg, B, "cpu"))
            out[f"{name}_one"] = one[:, -1]
            out[f"{name}_one_decode"] = llama.decode_step(model, one[:, -1].argmax(-1).int(),
                                                          one_cache)[0]
    cfg = _tiny()
    full = load_llama(str(d / "sp_plain"), cfg, "cpu")
    dense = llama.KVCache.init(cfg, 2, "cpu")
    msgs = [_raises(lambda: seqpar.sp_prefill(full, cfg, seq, torch.zeros((2, 10), dtype=torch.long),
                                              dense)),
            _raises(lambda: seqpar.sp_prefill(full, cfg, seq, torch.zeros((2, 32), dtype=torch.long),
                                              llama.KVCache.init(cfg, 2, "cpu", quantized=True))),
            _raises(lambda: seqpar.sp_prefill(full, cfg, seq, torch.zeros((2, 32), dtype=torch.long),
                                              llama.KVCache.init_paged(cfg, 2, 4, 16,
                                                                       device="cpu"))),
            _raises(lambda: seqpar.sp_prefill(full, cfg, seq, torch.zeros((2, 128), dtype=torch.long),
                                              dense))]
    (d / f"raises_rank{rank}.json").write_text(json.dumps(msgs))
    _save(d, "seq4", rank, **out)


# --- the world deadline (tests/test_torch_world_deadline.py) ---


def hang(rank: int, d: Path) -> None:
    """Never ends: rank 0 waits in a barrier that the other ranks never enter."""
    if rank == 0:
        torch.distributed.barrier()
    else:
        threading.Event().wait()
