"""Shared building blocks (the port of ``btia_tpu/models/layers.py``).

Parameter names and layouts are the flax ones: a Dense holds ``kernel``
(in, out) and ``bias``, a LayerNorm ``scale`` and ``bias``, an Embed
``embedding`` (vocab, dim). The module tree mirrors the flax scopes, so the
weight bridge (``convert/from_jax.py``) is a rename of dotted paths.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.ops.fused_attn import fused_dense_attention
from btia_tpu_torch.ops.gemm import apply_act, gemm_bias, gemm_takes, prepare_once
from btia_tpu_torch.ops.norms import layernorm
from btia_tpu_torch.ops.quant import int8_matmul_nk, int8_matmul_row_parallel, int8_weight
from btia_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from btia_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size


class Dropout:
    """Train-time dropout as flax's ``nn.Dropout``: keep each element with
    probability 1 - rate, scaling kept ones by 1 / (1 - rate). The bits come
    from an explicit ``torch.Generator`` (seeded per train step), so a run
    and its resumption draw the same masks. Modules take ``drop=None`` for
    the deterministic (eval) forward."""

    def __init__(self, rate: float, generator: torch.Generator):
        self.keep = 1.0 - rate
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mask = torch.empty_like(x).bernoulli_(self.keep, generator=self.generator)
        return x / self.keep * mask


def maybe_drop(x: torch.Tensor, drop: Optional[Dropout]) -> torch.Tensor:
    return x if drop is None else drop(x)


@contextlib.contextmanager
def _replayed(generator: torch.Generator, state: torch.Tensor):
    """Run the body from the generator state `state`, then put the generator
    back where it was."""
    now = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(now)


def remat(block: nn.Module, *tensors, drop: Optional[Dropout], train: bool):
    """``block(*tensors, drop, train)`` rematerialised, as flax's
    ``nn.remat``: the backward pass recomputes the block's forward instead
    of keeping its activations (``torch.utils.checkpoint``, non-reentrant).

    ``checkpoint``'s ``preserve_rng_state`` restores only the default
    generators, and the masks come from ``drop.generator``: the recompute
    would draw other masks and give wrong gradients without an error. So
    the recompute runs from that generator's state before the block, and
    leaves the generator where it found it, which is where the forward
    left it. Without autograd there is nothing to recompute."""
    run = lambda *t: block(*t, drop, train)
    if not torch.is_grad_enabled():
        return run(*tensors)
    if drop is None:
        return checkpoint(run, *tensors, use_reentrant=False)
    gen, before, calls = drop.generator, drop.generator.get_state(), [0]

    def replaying(*t):
        calls[0] += 1
        if calls[0] == 1:  # the forward
            return run(*t)
        with _replayed(gen, before):
            return run(*t)

    return checkpoint(replaying, *tensors, use_reentrant=False)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = 1) -> torch.Tensor:
    """Mean over tokens, ignoring padding (``layers.py:masked_mean``): x
    (B, S, D), mask (B, S) True = a real token."""
    if mask is None:
        return x.mean(dim)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim) / torch.clamp_min(m.sum(dim), 1.0)


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32, device=device))


class Dense(nn.Module):
    """nn.Dense / QuantizableDense: rows flattened to 2-D. ``forward`` runs
    the operands and the bias add in the compute dtype, then ``act`` (None
    or ``"gelu_tanh"``); ``reduce``, for a row-parallel product under a
    model axis, sums the product over the model group before the bias.

    Where ``epilogue_takes`` holds (a bf16 CUDA input, no gradient wanted,
    no ``reduce``, K and N multiples of 8) the product, the f32 bias and the
    activation are one launch of the projection GEMM
    (``ops/gemm.py::gemm_bias``, the bias and GELU in its epilogue,
    one bf16 rounding) on the kernel cast to bf16 once per version of it
    (``prepare_once``); every other call runs the chain (cast, matmul, bias
    add, activation). ``Dense.epilogue_calls`` and ``Dense.chain_calls``
    count the calls each way.

    ``int8`` runs the product through K8 with ``act`` in its epilogue, on
    the fp32 kernel quantized once per version of it (``int8_weight``): the
    reference quantizes on every call (``layers.py:172-177``), which gives
    the same int8 values and scales."""

    epilogue_calls = 0
    chain_calls = 0

    def __init__(self, in_dim: int, features: int, policy: DTypePolicy, device=None):
        super().__init__()
        self.policy = policy
        self.kernel = _param(in_dim, features, device=device)
        self.bias = _param(features, device=device)

    def epilogue_takes(self, x: torch.Tensor, reduce=None) -> bool:
        """Whether a call on `x` runs on the epilogue GEMM: x on the card,
        no gradient wanted (grad mode off, or neither x nor the parameters
        require one), no ``reduce``, and operands the kernel takes
        (``gemm_takes``: the bf16 compute dtype, K and N multiples of 8)."""
        wants_grad = torch.is_grad_enabled() and (
            x.requires_grad or self.kernel.requires_grad or self.bias.requires_grad)
        return (x.is_cuda and not wants_grad and reduce is None
                and gemm_takes(self.policy.compute_dtype, *self.kernel.shape))

    def forward(self, x: torch.Tensor, act: Optional[str] = None, reduce=None) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x2 = x.reshape(-1, x.shape[-1]).to(cd)
        if self.epilogue_takes(x2, reduce):
            Dense.epilogue_calls += 1
            w, = prepare_once((self.kernel,), ("cast", cd), lambda: (self.kernel.to(cd),))
            y = gemm_bias(x2, w, self.bias, act=act)
        else:
            Dense.chain_calls += 1
            y = torch.matmul(x2, self.kernel.to(cd))
            y = apply_act((y if reduce is None else reduce(y)) + self.bias.to(cd), act)
        return y.reshape(*x.shape[:-1], self.kernel.shape[1])

    def int8(self, x: torch.Tensor, act: Optional[str] = None, x_amax=None, row_amax: bool = False,
             row_parallel: bool = False):
        """The int8 product (``int8_matmul_nk``); ``x_amax`` / ``row_amax``
        pass the rows' amax between an Mlp's two products. ``row_parallel``
        under a model axis: this rank's rows of the weight, summed over the
        group (``int8_matmul_row_parallel``, which takes x_amax)."""
        cd = self.policy.compute_dtype
        x2 = x.reshape(-1, x.shape[-1]).to(cd)
        row_parallel = row_parallel and axis_size(MODEL_AXIS) > 1
        w_nk, w_scale = int8_weight(self.kernel, row_parallel)
        if row_parallel:
            if x_amax is None:
                raise ValueError("a row-parallel int8 product takes its input's row amax (x_amax)")
            y = apply_act(int8_matmul_row_parallel(x2, x_amax, w_nk, w_scale, self.bias, cd), act)
        else:
            y = int8_matmul_nk(x2, w_nk, w_scale, self.bias, act, cd, x_amax=x_amax, row_amax=row_amax)
        if row_amax:
            y, amax = y
            return y.reshape(*x.shape[:-1], self.kernel.shape[1]), amax
        return y.reshape(*x.shape[:-1], self.kernel.shape[1])


class LayerNormParams(nn.Module):
    """Holds (scale, bias) for a LayerNorm folded into a fused site."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    def triple(self):
        return self.scale, self.bias, self.eps


class LayerNorm(LayerNormParams):
    """Fast-variance f32 LayerNorm, output in the compute dtype: K7 on the
    card, its plain twin on the CPU (``ops/norms.py::layernorm``). ``fast``
    is passed as the reference passes it (``layers.py:260-261``);
    ``layernorm`` ignores it, as the reference's does."""

    def __init__(self, dim: int, policy: DTypePolicy, eps: float = 1e-6, device=None):
        super().__init__(dim, eps, device)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        return layernorm(x, self.scale, self.bias, self.eps, fast=cd == torch.bfloat16).to(cd)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.embedding = _param(num, dim, device=device)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.embedding(ids, self.embedding.to(dtype))


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention through ``fused_dense_attention`` (K1); the
    site arguments fold the surrounding block's LNs and residual into it."""

    def __init__(self, dim: int, num_heads: int, policy: DTypePolicy,
                 q_dim: Optional[int] = None, kv_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.policy = policy
        self.q_proj = Dense(q_dim or dim, dim, policy, device)
        self.k_proj = Dense(kv_dim or dim, dim, policy, device)
        self.v_proj = Dense(kv_dim or dim, dim, policy, device)
        self.o_proj = Dense(dim, out_dim or dim, policy, device)

    def forward(self, x_q, x_kv=None, kv_mask=None, q_ln=None, kv_ln=None,
                residual=False, post_ln=None):
        cd = self.policy.compute_dtype
        x_kv = x_q if x_kv is None else x_kv
        return fused_dense_attention(
            x_q.to(cd), x_kv.to(cd), kv_mask,
            self.q_proj.kernel, self.q_proj.bias,
            self.k_proj.kernel, self.k_proj.bias,
            self.v_proj.kernel, self.v_proj.bias,
            self.o_proj.kernel, self.o_proj.bias,
            self.num_heads,
            q_ln=q_ln, kv_ln=kv_ln, residual=residual, post_ln=post_ln,
        )


class Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> fc2. GELU is exact (erf) under the fp32
    policy, the parity rail, and the tanh form under bf16
    (``layers.py:221-225``), which fc1 takes as its ``act``: in the
    projection GEMM's epilogue where ``Dense.epilogue_takes`` holds, after
    the bias add otherwise, as the chain always ran it. ``inner_dropout`` is
    the flax module's own ``dropout`` field: set for the ViT blocks and the
    AD head, off in BERT and BTIA, whose dropout sits outside the Mlp
    (``layers.py:239-240``).

    Under ``policy.int8`` a deterministic forward (``train`` False) runs both
    products through K8 with the tanh-GELU in fc1's epilogue
    (``layers.py:228-233``); fc1 also returns its rows' amax, at which fc2
    quantizes the hidden rows in its GEMM (no quantization pass between
    them; the same int8 values). The branch keys on ``train``, not on
    ``drop``: a train forward at dropout 0 has no Dropout and stays on the
    fp path.

    Under a model axis tp > 1 (``ops.fused_mesh``) fc1 holds this rank's
    hidden columns and fc2 its hidden rows (Megatron's column -> row pair):
    the input's gradient sums over the model group, and fc2's product is
    summed over it before the whole bias. Under int8 fc1 needs nothing of
    the group (x is whole on every rank, the weight scales are per output
    column, the GELU elementwise); fc2 takes each hidden row's amax and
    each output column's weight scale over the group (max all-reduces) and
    sums its int32 products there, so an int8 Mlp under tp > 1 gives the
    one-process result bit for bit, which is what the reference's gathered
    product computes."""

    def __init__(self, dim: int, hidden_dim: int, policy: DTypePolicy, device=None,
                 inner_dropout: bool = False):
        super().__init__()
        self.policy = policy
        self.inner_dropout = inner_dropout
        self.fc1 = Dense(dim, hidden_dim, policy, device)
        self.fc2 = Dense(hidden_dim, dim, policy, device)

    def forward(self, x: torch.Tensor, drop: Optional[Dropout] = None,
                train: bool = False) -> torch.Tensor:
        if self.policy.int8 and not train:
            h, amax = self.fc1.int8(x, "gelu_tanh", row_amax=True)
            return self.fc2.int8(h, x_amax=amax, row_parallel=True)
        if self.policy.compute_dtype == torch.float32:
            h = F.gelu(self.fc1(copy_to_model(x)), approximate="none")
        else:
            h = self.fc1(copy_to_model(x), act="gelu_tanh")
        # The sum over the model group only where there is one: without it
        # fc2 may take the epilogue GEMM.
        reduce = reduce_from_model if axis_size(MODEL_AXIS) > 1 else None
        return self.fc2(maybe_drop(h, drop if self.inner_dropout else None), reduce=reduce)
