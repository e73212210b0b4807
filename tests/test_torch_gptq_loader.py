"""The port's AutoGPTQ loader (``io/gptq_loader.py``) and ``formats.concat_qtensors``
against the JAX package, on the checkpoints ``tests/test_io.py`` writes:
``llama_config_from_hf`` equal field by field; the loaded model's every tensor
equal bit for bit to the JAX loader's tree after ``params_from_numpy`` (fused
and unfused, with the act-order gate and the desc_act checkpoint's down-proj
fold); a projection's dequantized weight equal to the interchange oracle;
prefill logits within rel 2e-2 of JAX's; the packed round trip, whose
directory the JAX loader reads back to its own tree.  Mixtral, AutoGPTQ and
dense: the config, every tensor bit-equal to the JAX loader's (stacked
experts), and the AutoGPTQ model's prefill logits within rel 2e-2.  ``concat_qtensors``
equals JAX's bit for bit where the fused N needs no lane padding; where it
does (N not a multiple of 128) the JAX function raises (it pads the 3-D
scales with a 2-D pad list), so the port's result is held to the parts'
dequantized weights side by side, and its padding to ``make_qtensor``'s
(scale 1, scale-zero 0).  ``tp=2`` raises ``NotImplementedError`` for
Mixtral, as JAX's loader does (the Llama case is in ``tests/test_torch_tp_io.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as st_np

from tests.test_io import (  # noqa: F401  (fixtures: the JAX tests' own checkpoints)
    BITS,
    DFFN,
    DH,
    GROUP,
    H,
    VOCAB,
    ckpt_dir,
    desc_ckpt_dir,
    mixtral_ckpt_dir,
)
from xbitops_tpu import formats as jformats
from xbitops_tpu.io import gptq_loader as jloader
from xbitops_tpu.io import load_packed as jload_packed
from xbitops_tpu.models import llama as jllama
from xbitops_tpu_torch import formats
from xbitops_tpu_torch.io import llama_config_from_hf, load_autogptq, load_packed, save_packed
from xbitops_tpu_torch.io.convert import params_from_numpy, qtensor_from_numpy
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.ops.qmatmul import qmatmul

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores (torch's thread pools spin while they wait)
torch.set_num_threads(1)

HF_CONFIGS = {
    "llama": dict(model_type="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=32, rope_theta=10000.0, rms_norm_eps=1e-5,
                  max_position_embeddings=64),
    "ntk_defaults": dict(vocab_size=1000, hidden_size=256, intermediate_size=512,
                         num_hidden_layers=3, num_attention_heads=8,
                         rope_scaling={"rope_type": "dynamic", "factor": 2.0},
                         max_position_embeddings=8192),
    "mistral": dict(model_type="mistral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, rope_theta=1e6, sliding_window=4096,
                    rope_scaling={"type": "linear", "factor": 4.0}),
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
@pytest.mark.parametrize("max_seq_len", [None, 32])
def test_llama_config_from_hf_matches_jax(name, max_seq_len):
    got = llama_config_from_hf(HF_CONFIGS[name], max_seq_len)
    want = jloader.llama_config_from_hf(HF_CONFIGS[name], max_seq_len)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def _jax_model(path, cfg, **kw):
    params, _ = jloader.load_autogptq(str(path), **kw)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")


def _same_model(a: llama.Llama, b: llama.Llama) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        if sa[name] is None or sb[name] is None:
            assert sa[name] is None and sb[name] is None, name
            continue
        assert sa[name].dtype == sb[name].dtype and torch.equal(sa[name], sb[name]), name
    ma, mb = dict(a.named_modules()), dict(b.named_modules())
    assert ma.keys() == mb.keys()
    for name in ma:
        assert getattr(ma[name], "meta", None) == getattr(mb[name], "meta", None), name


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_load_autogptq_equals_jax_loader(ckpt_dir, fuse):
    """Every tensor of the loaded model bit-equal to the JAX loader's; layer 0's
    act-order gate keeps gate/up apart, layer 1 fuses them; q|k|v fuse."""
    d, _ = ckpt_dir
    model, cfg = load_autogptq(str(d), fuse=fuse, device="cpu")
    _, want = _jax_model(d, cfg, fuse=fuse)
    _same_model(model, want)
    b0, b1 = model.blocks
    names0 = {n for n, _ in b0.named_children()}
    if fuse:
        assert {"wqkv", "w_gate", "w_up"} <= names0 and "w_gateup" not in names0
        assert b0.w_gate.qtensor.perm is not None and b1.w_gateup.qtensor.shape == (H, 2 * DFFN // 2)
        assert b0.wqkv.qtensor.shape == (H, 256)
    else:
        assert {"wq", "wk", "wv", "w_gate", "w_up"} <= names0 and b0.wq.qtensor.perm is None
    assert model.lm_head.weight.shape == (H, VOCAB)  # dense, transposed
    assert cfg.num_layers == 2 and cfg.max_seq_len == 64


def test_load_autogptq_dequant_parity(ckpt_dir):
    """A loaded projection dequantizes exactly like the interchange oracle with
    AutoGPTQ's zero - 1 convention, in the port and in the JAX package."""
    d, golden = ckpt_dir
    model, _ = load_autogptq(str(d), fuse=False, device="cpu")
    qweight, s16, qzeros = golden["model.layers.0.self_attn.q_proj"]
    want = formats.dequant_reference(
        torch.from_numpy(qweight), torch.from_numpy(s16), torch.from_numpy(qzeros), GROUP,
        BITS, H, add_zero_bias=1, out_dtype=torch.float32)
    got = formats.dequant_qtensor_reference(model.blocks[0].wq.qtensor, torch.float32)
    assert torch.equal(got, want)
    jwant = jformats.dequant_reference(jnp.asarray(qweight), jnp.asarray(s16),
                                       jnp.asarray(qzeros), GROUP, BITS, H, add_zero_bias=1,
                                       out_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def _logits_close(got: torch.Tensor, want, rel=2e-2):
    want = torch.from_numpy(np.asarray(want, np.float32))
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max() <= rel * want.abs().max()


def test_load_autogptq_forward_matches_jax(ckpt_dir):
    d, _ = ckpt_dir
    model, cfg = load_autogptq(str(d), max_seq_len=32, device="cpu")
    tokens = np.asarray([[1, 5, 9], [2, 4, 0]], np.int32)
    got, _ = llama.prefill(model, torch.from_numpy(tokens), llama.KVCache.init(cfg, 2, "cpu"))
    jparams, jcfg = jloader.load_autogptq(str(d), max_seq_len=32)
    want, _ = jllama.prefill(jparams, jcfg, jnp.asarray(tokens), jllama.KVCache.init(jcfg, 2))
    assert got.shape == (2, 3, VOCAB)
    _logits_close(got, want)


def test_packed_round_trip_and_jax_reads_it(ckpt_dir, tmp_path):
    """The loaded model saved and loaded again is the same model; the JAX
    loader reads the directory back to its own loader's tree."""
    d, _ = ckpt_dir
    model, cfg = load_autogptq(str(d), device="cpu")
    save_packed(model, str(tmp_path))
    back = params_from_numpy(load_packed(str(tmp_path), "cpu"), cfg, "cpu")
    _same_model(back, model)
    jparams, _ = jloader.load_autogptq(str(d))
    flat_a, tree_a = jax.tree_util.tree_flatten(jload_packed(str(tmp_path)))
    flat_b, tree_b = jax.tree_util.tree_flatten(jparams)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_desc_act_fold_at_tp1(desc_ckpt_dir):
    """desc_act on every projection: down_proj's row sort is folded into
    gate/up's columns (no perm on w_down), o_proj keeps its runtime perm,
    gate/up stay apart; every tensor equals the JAX loader's, the fold holds
    against the GPTQ semantics in f32 (rel 1e-5 / abs 3e-4), and prefill
    logits agree with JAX's within rel 2e-2."""
    d = desc_ckpt_dir
    model, cfg = load_autogptq(str(d), max_seq_len=32, device="cpu")
    jparams, want = _jax_model(d, cfg, max_seq_len=32)
    _same_model(model, want)
    b0 = model.blocks[0]
    assert b0.w_down.qtensor.perm is None and b0.wo.qtensor.perm is not None
    assert not hasattr(b0, "w_gateup")

    tensors = st_np.load_file(str(d / "model.safetensors"))
    order = np.argsort(tensors["model.layers.0.mlp.down_proj.g_idx"], kind="stable")

    def dense(prefix, k):  # GPTQ semantics: per-row g_idx lookup, zero - 1
        g = tensors[f"{prefix}.g_idx"].astype(np.int64)
        s16 = tensors[f"{prefix}.scales"].astype(np.float16)
        wq = formats.gptq_unpack_weight(torch.from_numpy(tensors[f"{prefix}.qweight"]), BITS, k)
        z = formats.gptq_unpack_zeros(torch.from_numpy(tensors[f"{prefix}.qzeros"]), BITS,
                                      s16.shape[1]).numpy().astype(np.float16)
        sz = (s16 * (z + np.float16(1.0))).astype(np.float32)
        return wq.numpy().astype(np.float32) * s16.astype(np.float32)[g] - sz[g]

    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, DH)).astype(np.float32) * 0.3
    got = qmatmul(torch.from_numpy(a), b0.w_gate.qtensor, out_dtype=torch.float32, precise=True)
    want_gate = a @ dense("model.layers.0.mlp.gate_proj", DH)[:, order]
    np.testing.assert_allclose(got.numpy(), want_gate, rtol=1e-5, atol=3e-4)
    b = rng.standard_normal((2, DFFN)).astype(np.float32) * 0.3
    got = qmatmul(torch.from_numpy(b), b0.w_down.qtensor, out_dtype=torch.float32, precise=True)
    want_down = b @ dense("model.layers.0.mlp.down_proj", DFFN)[order, :]
    np.testing.assert_allclose(got.numpy(), want_down, rtol=1e-5, atol=3e-4)

    tokens = np.array(jax.random.randint(jax.random.PRNGKey(4), (2, 5), 0, 512), np.int32)
    got, _ = llama.prefill(model, torch.from_numpy(tokens).long(),
                           llama.KVCache.init(cfg, 2, "cpu"))
    jcfg = jloader.llama_config_from_hf(
        {"vocab_size": 512, "hidden_size": DH, "intermediate_size": DFFN,
         "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 128}, 32)
    jlogits, _ = jllama.prefill(jparams, jcfg, jnp.asarray(tokens), jllama.KVCache.init(jcfg, 2))
    _logits_close(got, jlogits)


def _random_qt(seed, K, N, bits=4, g=32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    wq, s, z = jformats.quantize(w, bits, g)
    return jformats.make_qtensor(jnp.asarray(wq), jnp.asarray(s.astype(np.float16)),
                                 jnp.asarray(z), bits, g)


@pytest.mark.parametrize("widths,bits", [((128, 64, 64), 4), ((256, 256), 3)],
                         ids=["qkv", "gateup_3bit"])
def test_concat_qtensors_equals_jax(widths, bits):
    jparts = [_random_qt(i, 128, n, bits) for i, n in enumerate(widths)]
    want = qtensor_from_numpy(jax.tree.map(np.asarray, jformats.concat_qtensors(jparts)), "cpu")
    got = formats.concat_qtensors(
        [qtensor_from_numpy(jax.tree.map(np.asarray, p), "cpu") for p in jparts])
    assert got.shape == want.shape == (128, sum(widths))
    for f in ("bits", "group_size", "tile_k", "K", "K_logical", "N_logical", "perm"):
        assert getattr(got, f) == getattr(want, f), f
    assert all(torch.equal(a, b) for a, b in zip(got.planes, want.planes))
    assert torch.equal(got.scales, want.scales) and torch.equal(got.scale_zeros, want.scale_zeros)


def test_concat_qtensors_pads_lanes():
    """Parts of 96 and 64 columns (each padded to 128 lanes): the fused 160
    columns pad to 256 with scale 1 and scale-zero 0, and dequantize to the
    JAX parts' weights side by side."""
    jparts = [_random_qt(i, 128, n) for i, n in enumerate((96, 64))]
    got = formats.concat_qtensors(
        [qtensor_from_numpy(jax.tree.map(np.asarray, p), "cpu") for p in jparts])
    assert got.shape == (128, 160) and got.N == 256 and got.N_logical == 160
    want = np.concatenate([np.asarray(jformats.dequant_qtensor_reference(p, jnp.float32))
                           for p in jparts], axis=1)
    np.testing.assert_array_equal(
        formats.dequant_qtensor_reference(got, torch.float32).numpy(), want)
    assert bool((got.scales[..., 160:] == 1).all()) and not got.scale_zeros[..., 160:].any()
    assert not any(p[:, 160:].any() for p in got.planes)


def test_concat_qtensors_refuses():
    a, b = (qtensor_from_numpy(jax.tree.map(np.asarray, _random_qt(i, 128, 128)), "cpu")
            for i in range(2))
    with pytest.raises(ValueError, match="permutation"):  # order must permute the columns
        formats.concat_qtensors([a, b], order=np.arange(255))
    with pytest.raises(ValueError, match="act-order"):
        formats.concat_qtensors([a, dataclasses.replace(b, perm=torch.arange(128))])
    c = qtensor_from_numpy(jax.tree.map(np.asarray, _random_qt(2, 128, 128, bits=3)), "cpu")
    with pytest.raises(ValueError, match="metadata"):
        formats.concat_qtensors([a, c])


def test_mixtral_and_tp_raise(mixtral_ckpt_dir, ckpt_dir):
    """A Mixtral config is a no-drop ``MoeConfig``; ``tp > 1`` raises for
    Mixtral (it shards over the expert axis), as the JAX loader does, and
    packs a Llama checkpoint row-sharded (``tests/test_torch_tp_io.py``)."""
    from xbitops_tpu_torch.models.moe import MoeConfig

    cfg = llama_config_from_hf({**HF_CONFIGS["llama"], "model_type": "mixtral",
                                "num_local_experts": 4})
    assert isinstance(cfg, MoeConfig) and cfg.n_experts == 4 and cfg.capacity_factor is None
    with pytest.raises(NotImplementedError, match="EXPERT"):
        load_autogptq(str(mixtral_ckpt_dir), tp=2, device="cpu")
    model, _ = load_autogptq(str(ckpt_dir[0]), tp=2, device="cpu")
    assert formats.is_row_sharded(model.blocks[0].wo.qtensor)


def test_load_mixtral_autogptq_equals_jax_loader(mixtral_ckpt_dir):
    """``tests/test_io.py``'s AutoGPTQ Mixtral (2 experts, top-2): the config
    field by field, every tensor bit-equal to the JAX loader's (router f32,
    w1|w3 fused per expert, experts stacked), and the prefill logits within
    rel 2e-2 of JAX's."""
    from xbitops_tpu_torch.models.moe import MoeConfig

    model, cfg = load_autogptq(str(mixtral_ckpt_dir), max_seq_len=32, device="cpu")
    jparams, jcfg = jloader.load_autogptq(str(mixtral_ckpt_dir), max_seq_len=32)
    assert isinstance(cfg, MoeConfig)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    _same_model(model, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    w = model.blocks[0].weights()
    assert set(w) >= {"router", "w_experts_gateup", "w_experts_down"} and "w_down" not in w
    assert w["w_experts_gateup"].planes[0].shape[0] == 2 and w["router"].dtype == torch.float32
    tokens = np.asarray([[1, 5, 9], [2, 4, 0]])
    jlog, _ = jllama.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                             jllama.KVCache.init(jcfg, 2))
    log, _ = llama.prefill(model, torch.from_numpy(tokens), llama.KVCache.init(cfg, 2, "cpu"))
    _logits_close(log, jlog)


def test_load_mixtral_dense_equals_jax_loader(tmp_path):
    """A dense Mixtral checkpoint (the quantizer's input, written by
    ``utils/structured.py``) loads as stacked dense experts ``[E, K, N]``,
    bit-equal to the JAX loader's tree."""
    from xbitops_tpu_torch.models.moe import MoeConfig
    from xbitops_tpu_torch.utils import structured

    cfg = dataclasses.replace(MoeConfig.tiny_moe(vocab=64, seq=32), num_layers=1,
                              hidden_size=128, intermediate_size=128)
    structured.write_hf_mixtral_checkpoint(structured.structured_moe_params(cfg), cfg,
                                           str(tmp_path))
    model, lcfg = load_autogptq(str(tmp_path), device="cpu")
    jparams, _ = jloader.load_autogptq(str(tmp_path))
    _same_model(model, params_from_numpy(jax.tree.map(np.asarray, jparams), lcfg, "cpu"))
    gu = model.blocks[0].weights()["w_experts_gateup"]
    assert gu.shape == (cfg.n_experts, 128, 256) and gu.dtype == torch.bfloat16
