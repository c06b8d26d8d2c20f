"""The port's int8 serving (``ops/quant.py``, K8's plain twin, the Mlp's
int8 branch and the whole model with ``int8_ffn``) against the JAX package.

Same numpy inputs on both sides; the JAX kernel runs in interpret mode, as
the JAX package's own tests run it on the CPU. Tolerances:

* ``quantize_weight``: the same bits.
* K8's twin against ``int8_matmul_fused(..., interpret=True)``: the integer
  product is exact on both sides and the epilogue is the same f32
  arithmetic, so bf16 outputs agree to one bf16 step at each element's
  magnitude, and f32 outputs to 1e-6 of the largest magnitude. Both get a
  floor of 1e-6 of the largest magnitude: where the tanh-GELU's
  1 + tanh(z) cancels (z < -4, outputs below 3e-5), the two libraries'
  f32 tanh differ by a few units in the last place of 1.
* The Mlp and the whole small model under ``policy.int8`` (bf16): the two
  packages round LayerNorm, attention and GELU outputs at different points
  (as on the bf16 path, ``test_torch_model.py``), and an input that differs
  by one bf16 step can move an element across an int8 rounding boundary,
  so the int8 path's gap is wider than the bf16 path's. Mlp outputs to
  2e-2 of their largest magnitude; the encoders' features (LayerNorm
  outputs up to ~4) to 2.5e-2 of theirs; logits (magnitude ~0.5) to 1e-2
  absolute, the bf16 path's tolerance.
* Where int8 stays off (``int8_ffn`` under fp32, a train forward at
  dropout 0), the port's outputs equal the fp model's bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.core.dtypes import BF16_POLICY as JBF16
from btia_tpu.models.layers import Mlp as JMlp
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu.ops import quant as JQ
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import load_jax_params
from btia_tpu_torch.core.dtypes import BF16_POLICY
from btia_tpu_torch.models.layers import Mlp
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.ops import quant as TQ

SMALL = {
    "model.image_encoder": "vit_test",
    "model.bert_layers": 2,
    "model.bert_hidden": 128,
    "model.bert_heads": 2,
    "model.hidden_dim": 128,
    "model.num_heads": 2,
    "model.btia_layers": 1,
    "model.answer_vocab_size": 64,
    "model.num_answer_queries": 8,
    "model.int8_ffn": True,
}
L = 32
JAX_GELU = functools.partial(jax.nn.gelu, approximate=True)


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers on one host; two threads each keep
    these CPU-bound tests from oversubscribing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, held as f32 (the same values on both sides)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """One bf16 step (8 significant bits) at each element's magnitude."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def _weight(rng, K, N):
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: the scale floor 1e-8 / 127
    return w


@pytest.mark.parametrize("shape", [(64, 32), (768, 3072), (257, 300)])
def test_quantize_weight_bits(shape):
    w = _weight(np.random.RandomState(0), *shape)
    w[5, :] *= 40.0  # a row of outliers sets every column's scale
    jw, js = JQ.quantize_weight(jnp.asarray(w))
    tw, ts = TQ.quantize_weight(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[3]) == np.float32(np.float32(1e-8) / np.float32(127.0))


@pytest.mark.parametrize("shape", [(100, 128, 128), (128, 256, 300), (100, 384, 257)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", [None, "gelu_tanh"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_int8_mm_plain_matches_the_pallas_kernel(shape, bias, act, out):
    M, K, N = shape
    rng = np.random.RandomState(M + K + N)
    x = _bf16(rng.randn(M, K) * 2.0)
    x[7] = 0.0  # an all-zero row: the activation scale floor
    w = _weight(rng, K, N)
    b = (rng.randn(N) * 0.1).astype(np.float32) if bias else None
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[out]
    jw, js = JQ.quantize_weight(jnp.asarray(w))
    ref = JQ.int8_matmul_fused(
        jnp.asarray(x, jnp.bfloat16), jw, js, None if b is None else jnp.asarray(b),
        act=JAX_GELU if act else None, out_dtype=jd, interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    tw, ts = TQ.quantize_weight(torch.from_numpy(w))
    got = TQ._int8_mm_plain(
        torch.from_numpy(x).to(torch.bfloat16), tw, ts,
        None if b is None else torch.from_numpy(b), act, td,
    )
    assert got.dtype == td and got.shape == (M, N)
    got = got.float().numpy()
    floor = 1e-6 * np.abs(ref).max()
    tol = floor + (_bf16_step(ref) if out == "bf16" else 0.0)
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()
    if b is None:
        assert not got[7].any()


def test_fused_reference_matches_the_oracle():
    """The plain oracle (x / s, clipped) against the reference's."""
    rng = np.random.RandomState(3)
    x = _bf16(rng.randn(256, 128) * 3.0)
    w = _weight(rng, 128, 64)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    tw, ts = TQ.quantize_weight(torch.from_numpy(w))
    jw, js = JQ.quantize_weight(jnp.asarray(w))
    out = TQ.int8_matmul_fused_reference(torch.from_numpy(x).to(torch.bfloat16), tw, ts,
                                         torch.from_numpy(b), "gelu_tanh", torch.float32)
    ref = JQ.int8_matmul_fused_reference(jnp.asarray(x, jnp.bfloat16), jw, js, jnp.asarray(b),
                                         act=JAX_GELU, out_dtype=jnp.float32)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_plain_ops_match_the_reference():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 5, 64) * 10).astype(np.float32)
    w = (rng.randn(64, 32) * 0.1).astype(np.float32)
    jx, jsx = JQ.quantize_activation(jnp.asarray(x))
    tx, tsx = TQ.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    jw, jws = JQ.quantize_weight(jnp.asarray(w))
    tw, tws = TQ.quantize_weight(torch.from_numpy(w))
    out = TQ.int8_matmul(torch.from_numpy(x), tw, tws, out_dtype=torch.float32)
    ref = JQ.int8_matmul(jnp.asarray(x), jw, jws, out_dtype=jnp.float32)
    assert out.shape == (2, 5, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(ref)).max()))
    assert TQ.quantization_error(torch.from_numpy(w)) == pytest.approx(
        JQ.quantization_error(jnp.asarray(w)), rel=1e-6)
    with pytest.raises(ValueError, match="act"):
        TQ.int8_matmul_fused(torch.from_numpy(x[0]), tw, tws, act="relu")


def _copy_mlp(tm: Mlp, params) -> None:
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            for leaf in ("kernel", "bias"):
                getattr(getattr(tm, name), leaf).copy_(torch.from_numpy(np.array(params[name][leaf])))


def test_mlp_int8_branch():
    rng = np.random.RandomState(5)
    x = _bf16(rng.randn(3, 50, 64))
    jpol = dataclasses.replace(JBF16, int8=True)
    jm = JMlp(64, 256, jpol)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tm = Mlp(64, 256, dataclasses.replace(BF16_POLICY, int8=True))
    _copy_mlp(tm, variables["params"])
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16))
        fp = tm(torch.from_numpy(x).to(torch.bfloat16), train=True)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 50, 64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2 * scale, rtol=0)
    # The int8 branch ran: the fp product differs by the quantization noise.
    assert np.abs(fp.float().numpy() - out.float().numpy()).max() > 1e-3 * scale


# ---------------------------------------------------------------------------
# The whole small model with int8_ffn
# ---------------------------------------------------------------------------


def _qids(rng, n):
    ids = np.zeros((n, L), np.int32)
    for i in range(n):
        k = rng.randint(3, L + 1)
        ids[i, :k] = rng.randint(1, 500, k)
    return ids


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i" else x)


@pytest.fixture(scope="module")
def int8_pair():
    jcfg = jax_get_config("streaming_vitl", **SMALL)
    jm = jax_build_model(jcfg.model)
    assert jm.policy.int8
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(
        {"params": key, "dropout": key},
        jnp.zeros((1, 96, 96, 3), jnp.uint8), jnp.ones((1, L), jnp.int32),
    )
    tm = build_model(get_config("streaming_vitl", **SMALL).model, device="cpu")
    assert tm.policy.int8 and tm.policy.compute_dtype == torch.bfloat16
    load_jax_params(tm, variables["params"])
    rng = np.random.RandomState(0)
    inputs = dict(
        images=rng.randint(0, 256, (2, 120, 120, 3)).astype(np.uint8),
        qids=_qids(rng, 6).reshape(2, 3, L),
        unique=_qids(rng, 4),
        qmap=rng.randint(0, 4, (2, 3)).astype(np.int32),
        pair_img=np.array([0, 1, 1, 0, 1], np.int32),
        pair_q=np.array([3, 0, 2, 2, 1], np.int32),
    )
    apply = jax.jit(lambda v, *a, method: jm.apply(v, *a, method=method), static_argnames="method")
    return apply, variables, tm, inputs


IMG = object()  # stands for the encoded images of the same inputs
_ENTRY = {
    "encode_image": lambda d: (d["images"],),
    "encode_question": lambda d: (d["unique"],),
    "answer_questions": lambda d: (IMG, d["qids"]),
    "answer_questions_indexed": lambda d: (IMG, d["unique"], d["qmap"]),
    "answer_pairs": lambda d: (IMG, d["unique"], d["pair_img"], d["pair_q"]),
    "__call__": lambda d: (d["images"], d["qids"][:, 0]),
}


@pytest.mark.parametrize("method", list(_ENTRY))
def test_int8_model_entry_points(int8_pair, method):
    apply, v, tm, d = int8_pair
    args = _ENTRY[method](d)
    jimg = apply(v, d["images"], method="encode_image")
    ref = apply(v, *[jimg if a is IMG else a for a in args], method=method)
    ref = np.asarray((ref[0] if method == "encode_question" else ref).astype(jnp.float32))
    with torch.no_grad():
        timg = tm.encode_image(_t(d["images"]))
        targs = [timg if a is IMG else _t(a) for a in args]
        fn = tm if method == "__call__" else getattr(tm, method)
        out = fn(*targs)
        out = (out[0] if method == "encode_question" else out).float().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    features = method.startswith("encode")
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.5e-2 * np.abs(ref).max() if features else 1e-2)


def _fp_twin(tm, mixed: bool, dropout: float = 0.1):
    """A port model of the same weights without int8_ffn."""
    over = dict(SMALL, **{"model.int8_ffn": False, "model.mixed_precision": mixed,
                          "model.dropout": dropout})
    fp = build_model(get_config("streaming_vitl", **over).model, device="cpu")
    fp.load_state_dict(tm.state_dict())
    return fp


def test_int8_off_under_fp32(int8_pair):
    _, _, tm, d = int8_pair
    over = dict(SMALL, **{"model.mixed_precision": False})
    m = build_model(get_config("streaming_vitl", **over).model, device="cpu")
    assert not m.policy.int8
    m.load_state_dict(tm.state_dict())
    fp = _fp_twin(tm, mixed=False)
    with torch.no_grad():
        a = m(_t(d["images"]), _t(d["qids"][:, 0]))
        b = fp(_t(d["images"]), _t(d["qids"][:, 0]))
    assert torch.equal(a, b)


def test_int8_off_in_a_train_forward_at_dropout_0(int8_pair):
    _, _, tm, d = int8_pair
    over = dict(SMALL, **{"model.dropout": 0.0})
    m = build_model(get_config("streaming_vitl", **over).model, device="cpu")
    assert m.policy.int8
    m.load_state_dict(tm.state_dict())
    fp = _fp_twin(tm, mixed=True, dropout=0.0)
    with torch.no_grad():
        images, qids = _t(d["images"]), _t(d["qids"][:, 0])
        train_i8, train_fp = m(images, qids, train=True), fp(images, qids, train=True)
        eval_i8, eval_fp = m(images, qids), fp(images, qids)
    assert torch.equal(train_i8, train_fp)
    assert torch.equal(eval_fp, train_fp)
    assert not torch.equal(eval_i8, eval_fp)  # and on in the eval forward
