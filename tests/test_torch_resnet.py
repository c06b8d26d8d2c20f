"""The port's ResNet encoder against the JAX package's, on the CPU.

Flax initialises ``resnet_tiny`` (four stages of one bottleneck) and
``resnet_xsmall`` (two stages); the weight bridge carries the parameters
(conv kernels HWIO -> OIHW) and the BatchNorm statistics across; both are
fed the same numpy images. The running statistics are set to seeded random
values (variance in [0.5, 1.5]) so that eval mode normalises by something
other than the initial (0, 1).

Tolerances: fp32 outputs within 1e-4 of their largest magnitude, the goldens'
fp32 tolerance (the two frameworks sum each convolution in another order);
the running statistics after a train forward within 1e-5 of their largest
magnitude (one f32 mean over the batch and grid on each side). bf16: within
2e-2 of the largest magnitude (observed 3.7e-3), since the two round the
compute-dtype convolution outputs and the residual sums at other points and
a bf16 step (2^-8 relative) compounds through each bottleneck's three
convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.core.dtypes import default_policy as jax_policy
from btia_tpu.models.resnet import build_resnet as jax_build_resnet
from btia_tpu_torch.convert.from_jax import flatten_params, load_jax_variables
from btia_tpu_torch.core.dtypes import default_policy
from btia_tpu_torch.models.resnet import BatchNorm, build_resnet

SIZES = {"resnet_tiny": 64, "resnet_xsmall": 32}


def _random_stats(stats, rng):
    """Seeded random running statistics of the same tree."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.2)
        else:
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return out


def _pair(name, mixed=False):
    jm = jax_build_resnet(name, jax_policy(mixed))
    s = SIZES[name]
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3), jnp.float32))
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], np.random.RandomState(1))}
    tm = build_resnet(name, default_policy(mixed), device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _images(B, s, seed=0):
    return np.random.RandomState(seed).randn(B, s, s, 3).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("name", ["resnet_tiny", "resnet_xsmall"])
def test_eval_forward_matches_jax(name):
    jm, v, tm = _pair(name)
    x = _images(3, SIZES[name])
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    grid = SIZES[name] // (32 if name == "resnet_tiny" else 8)
    assert got.shape == (3, grid * grid, 2048 if name == "resnet_tiny" else 512)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", ["resnet_tiny", "resnet_xsmall"])
def test_train_forward_normalises_with_batch_stats_and_updates_them(name):
    """Train mode: batch statistics (fast variance), and the running update
    with momentum 0.9 of the *biased* variance, against flax's mutable
    ``batch_stats``."""
    jm, v, tm = _pair(name)
    x = _images(4, SIZES[name], seed=2)
    want, new = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    got = tm(torch.from_numpy(x), train=True)
    _close(got.detach(), want, 1e-4)
    stats = flatten_params(new["batch_stats"])
    own = dict(tm.named_buffers())
    assert sorted(stats) == sorted(own)
    for key, w in stats.items():
        _close(own[key], w, 1e-5)
    before = flatten_params(v["batch_stats"])
    assert any(np.abs(stats[k] - before[k]).max() > 1e-3 for k in stats)  # they moved


def test_running_variance_is_the_biased_one():
    """One BatchNorm on a known batch: the running variance moves toward the
    biased batch variance (``F.batch_norm(training=True)`` would use the
    unbiased one, n / (n - 1) times larger)."""
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.scale.fill_(1.0)
        bn.bias.zero_()
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 2, 1, 3).astype(np.float32))
    bn(x, train=True)
    flat = x.reshape(-1, 3).double()
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * flat.mean(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * flat.var(0, unbiased=False).numpy(), rtol=1e-5)


def test_bf16_policy_matches_jax():
    jm, v, tm = _pair("resnet_tiny", mixed=True)
    x = _images(2, 64, seed=4)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 2e-2)


def test_tokens_are_the_grid_in_row_major_order():
    """Token i * W + j is grid cell (i, j) of the last stage's NHWC map."""
    tm = build_resnet("resnet_xsmall", default_policy(False), device="cpu")
    _, v, _ = _pair("resnet_xsmall")
    load_jax_variables(tm, v)
    seen = {}
    last = tm.stage2_block0
    last.register_forward_hook(lambda m, a, out: seen.setdefault("map", out))
    with torch.no_grad():
        tokens = tm(torch.from_numpy(_images(1, 40, seed=5)))
    grid = seen["map"]
    B, H, W, C = grid.shape
    assert (H, W) == (5, 5) and tokens.shape == (B, H * W, C)
    for i in range(H):
        for j in range(W):
            assert torch.equal(tokens[:, i * W + j], grid[:, i, j])


def test_bridge_transposes_conv_kernels_hwio_to_oihw():
    jm, v, tm = _pair("resnet_tiny")
    flax_k = np.asarray(v["params"]["stage2_block0"]["conv2"]["kernel"])  # (kh, kw, in, out)
    port_k = tm.stage2_block0.conv2.kernel.detach().numpy()  # (out, in, kh, kw)
    assert flax_k.shape == (3, 3, 128, 128) and port_k.shape == (128, 128, 3, 3)
    np.testing.assert_array_equal(port_k, flax_k.transpose(3, 2, 0, 1))
    # One 3x3 strided convolution alone, as the bottleneck's conv2 runs it.
    x = _images(1, 9, seed=6)[..., :1].repeat(128, -1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(flax_k), (2, 2), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    with torch.no_grad():
        got = tm.stage2_block0.conv2(torch.from_numpy(x))
    _close(got, want, 1e-5)
    # The statistics are part of the bridge: a missing collection raises.
    with pytest.raises(KeyError, match="batch_stats"):
        load_jax_variables(tm, {"params": v["params"]})


@pytest.mark.parametrize("name", ["resnet_tiny", "resnet_xsmall"])
def test_f32_gradients_match_jax(name):
    """Gradients of a fixed projection of the eval-mode tokens with respect
    to every parameter and to the images, through the f32 convolutions'
    own backward, against jax.grad: within 1e-4 of each tensor's largest."""
    jm, v, tm = _pair(name)
    s = SIZES[name]
    x = _images(2, s, seed=7)
    n_tok = (s // (32 if name == "resnet_tiny" else 8)) ** 2
    r = np.random.RandomState(8).randn(2, n_tok, 2048 if name == "resnet_tiny" else 512).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=False) * r)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(v["params"], x)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm(xt, train=False) * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, want_x, 1e-4)
    want = flatten_params(want_p)
    own = dict(tm.named_parameters())
    assert sorted(want) == sorted(own)
    for key, w in want.items():
        got = own[key].grad
        if got.ndim == 4:  # the bridge's HWIO -> OIHW
            w = np.asarray(w).transpose(3, 2, 0, 1)
        _close(got, w, 1e-4)


def test_f32_convolution_backward_runs_with_tf32_off(monkeypatch):
    """The f32 convolutions' backward runs inside ``loss.backward()``, after
    the forward's context has closed: it sets cuDNN's TF32 off itself, with
    the global setting left on (PyTorch's default); bf16 convolutions leave
    the setting alone."""
    seen = []
    real = torch.ops.aten.convolution_backward

    def spy(*args):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args)

    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tm = build_resnet("resnet_xsmall", default_policy(False), device="cpu")
    xt = torch.from_numpy(_images(1, 16, seed=9)).requires_grad_(True)
    tm(xt, train=True).sum().backward()
    n_convs = sum(1 for n, _ in tm.named_parameters() if n.endswith("kernel"))
    assert seen == [False] * n_convs
    assert torch.backends.cudnn.allow_tf32 is True
    seen.clear()
    tb = build_resnet("resnet_xsmall", default_policy(True), device="cpu")
    tb(xt, train=True).float().sum().backward()
    assert seen == []  # autograd's own convolution backward, not the f32 one
