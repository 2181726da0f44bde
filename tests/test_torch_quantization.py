"""Quantized weights in the port (``accelerate_tpu_torch/utils/quantization.py``,
``ops/fp8.py``'s quantized ``dense``, the streaming executor's quantized
segments) held against the JAX package's on the CPU, on the same numpy
weights and inputs.

The port keeps ``[out, in]`` weights, so its int8 codes and scales are
JAX's transposed, and its 4-bit indices and scale planes JAX's transposed
(JAX packs along ``out``, the port along ``in``, so the indices are compared
unpacked). Exact: int8 codes, scales and the int32 accumulators of the int8
GEMM (JAX's, captured from its ``jax.lax.dot`` / ``dot_general``); nf4 and
fp4 indices and scale planes; the eligible weights. Within 1e-6 of the
largest |value|: the dequantized weights and products. Logits of a
quantized model: 1e-5 against JAX's where both dequantize (f32); 5e-3 of
the largest |logit| against JAX's streamed int8 and 4-bit products (the
products' own arithmetic is exact above: an activation a rounding step
apart after f32 summation-order differences upstream moves its int8 code
by one, ~1e-3 of a logit), with the argmax kept at 95% of positions.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_zoo_common as common  # noqa: E402

from accelerate_tpu import big_modeling as jbm  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.models import opt as jopt  # noqa: E402
from accelerate_tpu.ops import fp8 as jfp8  # noqa: E402
from accelerate_tpu.utils import modeling as jmodeling  # noqa: E402
from accelerate_tpu.utils import quantization as jq  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch import native as tnative  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.models import opt as topt  # noqa: E402
from accelerate_tpu_torch.ops import fp8 as tfp8  # noqa: E402
from accelerate_tpu_torch.utils import modeling as tmodeling  # noqa: E402
from accelerate_tpu_torch.utils import quantization as tq  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(64, 48), (128, 96), (16, 40)]  # JAX's [in, out]


def _weight(shape, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


def _close(got, ref, rel=1e-6):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-12))


def _unpack(packed, axis):
    """4-bit indices from packed bytes (the high nibble first) along ``axis``."""
    packed = np.moveaxis(np.asarray(packed), axis, -1)
    idx = np.stack([packed >> 4, packed & 0xF], axis=-1).reshape(*packed.shape[:-1], -1)
    return np.moveaxis(idx, -1, axis)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_codes_and_scales_equal_jax_transposed(shape):
    w = _weight(shape)
    ref = jq.quantize_array(w)
    got = tq.quantize_array(torch.from_numpy(w.T.copy()))
    assert got.q.dtype == torch.int8 and tuple(got.scale.shape) == (shape[1], 1)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale).T)
    _close(got.dequantize().numpy(), np.asarray(jq.dequantize_array(ref)).T)


@pytest.mark.parametrize("m", [3, 24])
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_matmul_accumulators_and_product_equal_jax(monkeypatch, shape, m):
    """The row-quantized activations and the int32 accumulators equal those
    JAX's ``int8_matmul`` hands ``jax.lax.dot`` and gets back."""
    w = _weight(shape, 1)
    x = np.random.default_rng(2).normal(size=(2, m, shape[0])).astype(np.float32)
    captured = []
    dot = jax.lax.dot

    def spy(a, b, **kw):
        out = dot(a, b, **kw)
        captured.append((np.asarray(a), np.asarray(out)))
        return out

    monkeypatch.setattr(jax.lax, "dot", spy)
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), jq.quantize_array(w)))
    gemms = []
    gemm = tq.int8_gemm

    def tspy(a, b):
        out = gemm(a, b)
        gemms.append((a.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(tq, "int8_gemm", tspy)
    got = tq.int8_matmul(torch.from_numpy(x), tq.quantize_array(torch.from_numpy(w.T.copy())))
    (jx, jacc), = captured
    (tx, tacc), = gemms
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tacc, jacc)
    assert got.shape == (2, m, shape[1])
    _close(got.numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(3, 20, 5), (17, 64, 16), (40, 13, 9)])
def test_int8_gemm_pads_to_its_shape_rules_exactly(m, k, n):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, size=(n, 2 * k)).astype(np.int8))[:, :k]
    out = tq.int8_gemm(a, b)
    assert out.dtype == torch.int32 and tuple(out.shape) == (m, n)
    assert torch.equal(out.long(), a.long() @ b.long().t())


def test_int8_embedding_gather_scales_after():
    w = _weight((40, 16), 4)  # a table [vocab, hidden]
    qt = tq.quantize_array(torch.from_numpy(w))
    ids = torch.tensor([[3, 0, 39], [7, 7, 1]])
    _close(qt[ids].numpy(), qt.dequantize()[ids].numpy())
    assert tuple(qt[5].shape) == (16,)


# ---------------------------------------------------------------------------
# 4-bit
# ---------------------------------------------------------------------------


@pytest.mark.filterwarnings("ignore:quant_type='fp4'")
@pytest.mark.parametrize("block", [64, 16])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", SHAPES)
def test_4bit_indices_and_scale_planes_equal_jax_transposed(shape, quant_type, block):
    w = _weight(shape, 5)
    ref = jq.quantize_array_4bit(w, block_size=block, quant_type=quant_type)
    got = tq.quantize_array_4bit(torch.from_numpy(w.T.copy()), block_size=block,
                                 quant_type=quant_type)
    assert got.shape == (shape[1], shape[0]) and got.block_size == ref.block_size
    np.testing.assert_array_equal(_unpack(got.packed.numpy(), -1), _unpack(ref.packed, -1).T)
    np.testing.assert_array_equal(got.scale_q.numpy(), np.asarray(ref.scale_q).T)
    np.testing.assert_array_equal(got.scale_offset.numpy(), np.asarray(ref.scale_offset).T)
    np.testing.assert_array_equal(got.scale_scale.numpy(), np.asarray(ref.scale_scale).T)
    np.testing.assert_array_equal(got.code.numpy(), np.asarray(ref.code))
    _close(got.dequantize().numpy(), np.asarray(jq.dequantize_array_4bit(ref)).T)


@pytest.mark.parametrize("decoded", [False, True], ids=["packed", "decoded"])
@pytest.mark.parametrize("shape", SHAPES)
def test_4bit_products_and_block_accumulators_equal_jax(monkeypatch, shape, decoded):
    """``q4_matmul`` / ``q4_decoded_matmul``: each block's int32 partial sum
    equals the one JAX's ``dot_general`` returns for that block, and the
    products agree within 1e-6."""
    w = _weight(shape, 6)
    x = np.random.default_rng(7).normal(size=(5, shape[0])).astype(np.float32)
    jt = jq.quantize_array_4bit(w)
    captured = []
    dot_general = jax.lax.dot_general

    def spy(a, b, *args, **kw):
        out = dot_general(a, b, *args, **kw)
        captured.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.lax, "dot_general", spy)
    ref = np.asarray(jq.q4_matmul(jnp.asarray(x), jt))
    tt = tq.quantize_array_4bit(torch.from_numpy(w.T.copy()))
    if decoded:
        c8 = tnative.q4_decode_codes(tt.packed.numpy(), tq._int8_lut(tt.code).numpy())
        tt = tq.Q4DecodedTensor(torch.from_numpy(c8), tt.scale_q, tt.scale_offset, tt.scale_scale)
        assert torch.equal(tt.c8, tq.quantize_array_4bit(
            torch.from_numpy(w.T.copy())).codes_int8())
    parts = []
    gemm = tq.int8_gemm
    monkeypatch.setattr(tq, "int8_gemm", lambda a, b: parts.append(gemm(a, b)) or parts[-1])
    got = tfp8.dense(torch.from_numpy(x), tt)
    (jparts,) = captured
    np.testing.assert_array_equal(np.stack([p.numpy() for p in parts]), jparts)
    _close(got.numpy(), ref)


def test_4bit_embedding_gather_unpacks_only_the_rows():
    w = _weight((40, 64), 8)
    t = tq.quantize_array_4bit(torch.from_numpy(w), block_size=16)
    ids = torch.tensor([[3, 0, 39], [7, 7, 1]])
    _close(t[ids].numpy(), t.dequantize()[ids].numpy())
    c8 = torch.from_numpy(tnative.q4_decode_codes(t.packed.numpy(), tq._int8_lut(t.code).numpy()))
    d = tq.Q4DecodedTensor(c8, t.scale_q, t.scale_offset, t.scale_scale)
    _close(d[ids].numpy(), d.dequantize()[ids].numpy())
    with pytest.raises(ValueError, match="layout mismatch"):
        tq.Q4Tensor(t.packed, t.scale_q[:3], t.scale_offset, t.scale_scale, t.code)


def test_4bit_config_validation():
    with pytest.raises(ValueError, match="nf4"):
        tq.BnbQuantizationConfig(load_in_4bit=True, bnb_4bit_quant_type="int3")
    with pytest.raises(ValueError, match="exactly one"):
        tq.BnbQuantizationConfig(load_in_8bit=True, load_in_4bit=True)
    c = tq.BnbQuantizationConfig(load_in_4bit=True, bnb_4bit_compute_dtype="torch.bfloat16")
    jc = jq.BnbQuantizationConfig(load_in_4bit=True, bnb_4bit_compute_dtype="torch.bfloat16")
    assert not c.load_in_8bit and c.load_in_8bit == jc.load_in_8bit
    assert c.compute_dtype == torch.bfloat16 and jc.compute_dtype == jnp.bfloat16
    assert tq.BnbQuantizationConfig().compute_dtype == torch.float32


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

FAMILIES = {
    "llama": (jllama.LlamaForCausalLM, jllama.LlamaConfig.tiny(layers=2), tllama,
              tllama.LlamaForCausalLM),
    "opt": (jopt.OPTForCausalLM, jopt.OPTConfig.tiny(seq=64), topt, topt.OPTForCausalLM),
}


def _pair(name, seed=1):
    jcls, jcfg, tmod, tcls = FAMILIES[name]
    jmodel = jcls.from_config(jcfg, seed=seed)
    tcfg = common.port_config(getattr(tmod, type(jcfg).__name__), jcfg)
    return jmodel, common.port_model(tmod, tcls, tcfg, common.np_tree(jmodel.params))


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(2, 16)).astype(np.int32)


def _jax_quantized_leaves(jmodel):
    """``{expanded JAX name: QTensor | Q4Tensor}`` of a quantized JAX model."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jmodel.params, is_leaf=lambda l: isinstance(l, (jq.QTensor, jq.Q4Tensor)))[0]:
        if isinstance(leaf, (jq.QTensor, jq.Q4Tensor)):
            key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            out[key] = leaf
    return out


@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_quantized_model_planes_equal_jax(name, mode):
    """The same weights are eligible in both packages, and each layer's
    planes equal JAX's layer slice transposed."""
    jmodel, tmodel = _pair(name)
    config = dict(load_in_4bit=mode == "nf4")
    jq.quantize_model_params(jmodel, jq.BnbQuantizationConfig(**config))
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(**config))
    jleaves = _jax_quantized_leaves(jmodel)
    tmod = FAMILIES[name][2]
    expanded = {f"layers.{i}.{k[len('layers.'):]}" for k in jleaves for i in range(2)}
    got = {tmod.jax_param_name(n): qt for n, qt in tmodel.quantized_weights.items()}
    assert set(got) == expanded
    for name_, qt in got.items():
        _, i, leaf = name_.split(".")
        ref = jleaves[f"layers.{leaf}"]
        if mode == "int8":
            np.testing.assert_array_equal(qt.q.numpy(), np.asarray(ref.q[int(i)]).T)
            np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(ref.scale[int(i)]).T)
        else:
            np.testing.assert_array_equal(_unpack(qt.packed.numpy(), -1),
                                          _unpack(ref.packed[int(i)], -1).T)
            np.testing.assert_array_equal(qt.scale_q.numpy(), np.asarray(ref.scale_q[int(i)]).T)
    assert all(p.is_meta for n, p in tmodel.named_parameters() if n in tmodel.quantized_weights)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_quantized_forward_matches_jax(name, mode):
    """The model's own forward runs on the dequantized weights, as JAX's
    quantized ``apply_fn`` does."""
    jmodel, tmodel = _pair(name)
    config = dict(load_in_4bit=mode == "nf4")
    jq.quantize_model_params(jmodel, jq.BnbQuantizationConfig(**config))
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(**config))
    ids = _ids()
    ref = np.asarray(jmodel.apply_fn(jmodel.params, input_ids=jnp.asarray(ids))["logits"])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_streamed_quantized_products_match_jax(tmp_path, name, mode):
    """Streamed, the layers run the int8 products on the quantized weights
    (JAX's streamed arithmetic): its logits, over a host and disk map, and
    no segment takes the dequantize retry."""
    jmodel, tmodel = _pair(name)
    config = dict(load_in_4bit=mode == "nf4")
    jq.quantize_model_params(jmodel, jq.BnbQuantizationConfig(**config))
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(**config))
    ids = _ids(1)
    ref = np.asarray(jbm.cpu_offload(jmodel)(input_ids=ids).logits)
    calls = tnative.decode_calls
    dispatched = bm.dispatch_model(tmodel, {"": "cpu", "layers.1": "disk"}, main_device="cpu",
                                   offload_dir=str(tmp_path))
    got = dispatched(input_ids=ids).logits.numpy()
    _close(got, ref, rel=5e-3)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95
    assert dispatched.dequantize_retries == 0
    assert (tnative.decode_calls > calls) == (mode == "nf4")


def test_4bit_streaming_without_native_decoder(monkeypatch):
    """Where the host decoder cannot be built, the packed planes stream and
    the card decodes them: the same codes, the same logits, bit for bit."""
    _, tmodel = _pair("llama")
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(load_in_4bit=True))
    ids = _ids(2)
    with_native = bm.cpu_offload(tmodel, execution_device="cpu")(input_ids=ids).logits
    monkeypatch.setattr(tnative, "q4_decode_codes", lambda *a, **k: None)
    calls = tnative.decode_calls
    without = bm.cpu_offload(tmodel, execution_device="cpu")(input_ids=ids).logits
    assert tnative.decode_calls == calls
    assert torch.equal(with_native, without)


def test_dequantize_retry_only_for_a_foreign_segment_function():
    """A segment function that is not the zoo's and uses an operation the
    quantized weights do not take runs on their dequantized values (counted);
    a dense segment's own error stands."""

    class Foreign(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(_weight((16, 32), 9)))

        def segments(self, x):
            return {"init": lambda: x, "finalize": lambda c: c,
                    "steps": [("s", ["w"], lambda seg, c: c @ (seg["w"] * 0.5).t())]}

    model = Foreign()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32))
    dense = bm.cpu_offload(Foreign(), execution_device="cpu")
    with pytest.raises(TypeError):
        dense(None)  # the caller's TypeError over dense weights: no retry
    tq.quantize_model_params(model, tq.BnbQuantizationConfig())
    dispatched = bm.cpu_offload(model, execution_device="cpu")
    for _ in range(2):
        out = dispatched(x)
        ref = x @ (model.quantized_weights["w"].dequantize() * 0.5).t()
        assert torch.equal(out, ref)
    assert dispatched.dequantize_retries == 1


def test_eligibility_skips_embeddings_norms_and_named_modules():
    _, tmodel = _pair("llama")
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(skip_modules=["layers.1"]))
    assert set(tmodel.quantized_weights) == {
        f"layers.0.{k}.weight" for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
    _, emb = _pair("llama")
    tq.quantize_model_params(emb, tq.BnbQuantizationConfig(quantize_embeddings=True))
    assert {"embed_tokens.weight", "lm_head.weight"} <= set(emb.quantized_weights)
    assert "norm" not in emb.quantized_weights


def test_quantize_failure_leaves_model_intact():
    _, tmodel = _pair("opt")
    before = {n: p.clone() for n, p in tmodel.named_parameters()}
    with pytest.raises(ValueError, match="no parameters were eligible"):
        tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(skip_modules=[".*"]))
    assert not hasattr(tmodel, "quantized_weights")
    for n, p in tmodel.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_device_map_sizing_follows_the_planes(mode):
    """A quantized model is sized by its planes: int8 about a quarter of
    f32, 4-bit below it; the same budget that fits it refuses the f32
    model; JAX sizes its planes alike."""
    jmodel, tmodel = _pair("llama")
    fp32 = sum(int(np.prod(s)) * 4 for s, _ in tmodeling.flat_param_shapes(tmodel).values())
    config = dict(load_in_4bit=mode == "nf4")
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(**config))
    jq.quantize_model_params(jmodel, jq.BnbQuantizationConfig(**config))
    # the same bytes but the 16-entry codebooks (one a weight here, one a
    # layer-stacked leaf in JAX)
    jshapes = {k: v for k, v in jmodeling.flat_param_shapes(jmodel, expand_stacked="layers")
               .items() if not k.endswith(".code")}
    tshapes = {k: v for k, v in tmodeling.flat_param_shapes(tmodel).items()
               if not k.endswith(".code")}
    assert (tmodeling.compute_module_sizes(tshapes)[""]
            == jmodeling.compute_module_sizes(jshapes)[""])
    # the tables too (quantized along their last axis here, along the vocab
    # in JAX, so their scale planes differ in size)
    _, tmodel = _pair("llama")
    tq.quantize_model_params(tmodel, tq.BnbQuantizationConfig(quantize_embeddings=True,
                                                              **config))
    shapes = tmodeling.flat_param_shapes(tmodel)
    q_bytes = tmodeling.compute_module_sizes(shapes)[""]
    assert q_bytes < (0.3 if mode == "int8" else 0.2) * fp32
    budget = {0: int(q_bytes * 1.1), "cpu": 0, "disk": 0}
    assert set(map(str, tmodeling.infer_auto_device_map(shapes, max_memory=budget).values())) \
        == {"0"}
    with pytest.raises(ValueError, match="does not fit"):
        tmodeling.infer_auto_device_map(tmodeling.flat_param_shapes(_pair("llama")[1]),
                                        max_memory=budget)


def test_load_and_quantize_model_auto_map(tmp_path):
    """A checkpoint loaded into a freshly built model, quantized and
    dispatched in one call: the source's logits within int8's error."""
    _, src = _pair("llama", seed=4)
    tmodeling.save_safetensors(dict(src.named_parameters()), str(tmp_path / "model.safetensors"))
    ids = _ids(3)
    with torch.no_grad():
        ref = src(torch.from_numpy(ids)).logits.numpy()
    fresh = tllama.LlamaForCausalLM.from_config(src.config, seed=0, device="cpu")
    total = sum(p.numel() for p in fresh.parameters())
    quantized = tq.load_and_quantize_model(
        fresh, tq.BnbQuantizationConfig(), weights_location=str(tmp_path / "model.safetensors"),
        device_map="auto", max_memory={0: total, "cpu": total // 2, "disk": float("inf")},
        offload_folder=str(tmp_path / "offload"), main_device="cpu")
    assert isinstance(quantized, bm.DispatchedModel)
    assert set(map(str, quantized.hf_device_map.values())) > {"0"}
    out = quantized(input_ids=ids).logits.numpy()
    assert np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0) < 0.05
