"""A latent-attention, mixture-of-experts language model as the question
encoder (``question_encoder="mla_moe"``; ``streaming_kimivl`` runs
Kimi-VL-A3B-Instruct's, a DeepSeek-V3-style decoder). No counterpart in the
JAX package.

The question's WordPiece ids go through the layers causally (one pass, no
cache), then the final RMSNorm; the model's ``txt_proj`` takes it to the
fusion width. A layer is pre-norm: ``x += MLA(rms(x))``, then
``x += MLP(rms(x))``, the MLP a dense SwiGLU in the first ``lm_first_dense``
layers and a MoE layer after them.

* MLA (no q-LoRA): q = x Wq, split per head into a no-position part (nope)
  and a rotary part (rope); [c | k_pe] = x Wkv_a, the latent c RMS-normed and
  expanded by Wkv_b into each head's k_nope and v; k_pe one rotary key
  shared by every head. RoPE is DeepSeek's convention: the rotary half of q
  and k is de-interleaved ((x0, x1), (x2, x3), ... -> x0, x2, ..., x1, x3,
  ...) before the rotate-half rotation. Scores scaled by (nope + rope)^-0.5,
  causal, padding keys masked.
* MoE: the router's logits in f32 (x and its kernel upcast), sigmoid scores;
  the top-k of scores + the correction bias choose the experts; the chosen
  scores, normalised to sum 1 and times ``lm_routed_scale``, weigh them. The
  shared experts (one SwiGLU of ``lm_shared_experts`` x the expert width in
  the published code) are ``lm_shared_experts`` more groups of the expert
  width that every token visits at weight 1: the same sum.

Only the real tokens of a batch are computed: the layers run on the packed
rows ``token_index`` (flat (question, position) indices of the ids > 0),
the attention core too (``ops/mla.py``: each row attends to its own
question's rows up to itself). The serving path
(``infer/predict.py``) hands ``token_index`` over from the host, where it
knows the ids, so that no count is read back from the card; without it the
model finds the indices itself, a host read. Padding positions of the
output are zero.

Kernels on the card: every MLA projection is a ``Dense`` whose kernel is
held in the compute dtype and whose f32 bias stays zero (the published
model has none), so it runs on ``Dense``'s epilogue GEMM
(``ops/gemm.py::gemm_bias``); the dense SwiGLU and each MoE layer's experts on the grouped GEMM
(``ops/moe.py``, ``csrc/moe_gemm.cu``: a dense layer is one group); the
attention core on ``ops/mla.py::mla_attention`` (``csrc/mla_attn.cu``: the
packed rows, one launch a layer, where S <= 32 and the head widths are at
most the published ones); RMSNorm, RoPE, the router, the permutation and
combine plain PyTorch. Parameters are held in the compute dtype (bf16 on
the serving policy: 15.6 B of them fit one card only so), the router's
correction bias in f32. Serving only: a train forward raises.

Spans (``utils/profiling.py::span``): ``btia.lm.attn`` (a layer's MLA),
``btia.lm.moe`` (a whole MoE layer) and inside it ``btia.lm.moe.route``,
``btia.lm.moe.experts|<tokens>`` and ``btia.lm.moe.combine``. Counter:
``routed_rows()``, the rows routed to each expert of each MoE layer since the
model was made, summed on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import Dense
from btia_tpu_torch.ops import moe as M
from btia_tpu_torch.ops.mla import mla_attention
from btia_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LMSpec:
    layers: int = 27
    dim: int = 2048
    heads: int = 16
    vocab_size: int = 163840
    dense_width: int = 11264
    expert_width: int = 1408
    experts: int = 64
    shared_experts: int = 2
    experts_per_token: int = 6
    first_dense: int = 1
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 800000.0
    routed_scale: float = 2.446
    rms_eps: float = 1e-5

    @classmethod
    def of(cls, cfg) -> "LMSpec":
        """The spec of a ModelConfig's ``lm_*`` fields."""
        return cls(**{f.name: getattr(cfg, "lm_" + {"dim": "hidden"}.get(f.name, f.name))
                      for f in dataclasses.fields(cls)})


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class _Leaf(nn.Module):
    """One named parameter: ``kernel`` (in, out), ``scale`` or ``embedding``."""

    def __init__(self, name: str, *shape, dtype, device):
        super().__init__()
        self.register_parameter(name, _param(*shape, dtype=dtype, device=device))


def projection(in_dim: int, out_dim: int, policy: DTypePolicy, device) -> Dense:
    """A bias-less projection: a ``Dense`` with its kernel in the compute
    dtype and its f32 bias zero."""
    d = Dense(in_dim, out_dim, policy, device=device)
    d.kernel = nn.Parameter(torch.empty_like(d.kernel, dtype=policy.compute_dtype))
    return d


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * scale in f32, rounded once to `dtype`."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * scale.float()).to(dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek's rotary embedding of x (T, n, d) at positions pos (T,): the
    last dim de-interleaved, then x cos + rotate_half(x) sin, in f32."""
    T, n, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    freqs = pos.float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], -1)[:, None]
    xf = x.float().reshape(T, n, d // 2, 2).transpose(-1, -2).reshape(T, n, d)
    rot = torch.cat([-xf[..., d // 2 :], xf[..., : d // 2]], -1)
    return (xf * emb.cos() + rot * emb.sin()).to(x.dtype)


class MLA(nn.Module):
    def __init__(self, s: LMSpec, policy: DTypePolicy, device):
        super().__init__()
        self.s = s
        dt, dqk = policy.compute_dtype, s.qk_nope_dim + s.qk_rope_dim
        self.q_proj = projection(s.dim, s.heads * dqk, policy, device)
        self.kv_a_proj = projection(s.dim, s.kv_lora_rank + s.qk_rope_dim, policy, device)
        self.kv_norm = _Leaf("scale", s.kv_lora_rank, dtype=dt, device=device)
        self.kv_b_proj = projection(s.kv_lora_rank, s.heads * (s.qk_nope_dim + s.v_dim), policy, device)
        self.o_proj = projection(s.heads * s.v_dim, s.dim, policy, device)

    def forward(self, h: torch.Tensor, index: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """h (T, D) the normed real tokens at flat grid indices `index` and
        positions `pos`; mask (B, S) the real keys -> (T, D)."""
        s = self.s
        T = h.shape[0]
        H, dn, dr, dv, r = s.heads, s.qk_nope_dim, s.qk_rope_dim, s.v_dim, s.kv_lora_rank
        q = self.q_proj(h).view(T, H, dn + dr)
        ckv = self.kv_a_proj(h)
        kv = self.kv_b_proj(rms_norm(ckv[:, :r], self.kv_norm.scale, s.rms_eps, h.dtype)).view(T, H, dn + dv)
        q_pe = rope(q[..., dn:], pos, s.rope_theta)
        k_pe = rope(ckv[:, None, r:], pos, s.rope_theta)
        return self.o_proj(mla_attention(q, kv, q_pe, k_pe, index, mask))


class SwiGLU(nn.Module):
    """G SwiGLU MLPs of width `width` (the experts of a layer, or one dense
    MLP): ``gate_up`` (G, D, 2 width) holds [gate | up], ``down`` (G,
    width, D). Their products run on the grouped GEMM."""

    def __init__(self, groups: int, dim: int, width: int, dtype, device):
        super().__init__()
        self.gate_up = _param(groups, dim, 2 * width, dtype=dtype, device=device)
        self.down = _param(groups, width, dim, dtype=dtype, device=device)

    def forward(self, a: torch.Tensor, p: M.Plan, row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        return M.grouped_gemm(M.grouped_gemm(a, self.gate_up, p, "swiglu"), self.down, p, row_scale=row_scale)


class MoE(nn.Module):
    def __init__(self, s: LMSpec, dtype, device):
        super().__init__()
        self.s = s
        self.router = _Leaf("kernel", s.dim, s.experts, dtype=dtype, device=device)
        self.correction_bias = _param(s.experts, dtype=torch.float32, device=device)
        self.experts = SwiGLU(s.experts + s.shared_experts, s.dim, s.expert_width, dtype, device)
        self.routed_rows = None  # (experts,) int64 on the card, made at the first call

    def route(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, k) routed expert ids and their weights (f32) of the tokens h."""
        s = self.s
        scores = torch.sigmoid(h.float() @ self.router.kernel.float())
        _, idx = torch.topk(scores + self.correction_bias.float(), s.experts_per_token, dim=-1)
        w = scores.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * s.routed_scale

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h (T, D) -> the layer's (T, D) f32 output."""
        s = self.s
        T = h.shape[0]
        with span("btia.lm.moe"):
            with span("btia.lm.moe.route"):
                idx, w = self.route(h)
                shared = torch.arange(s.experts, s.experts + s.shared_experts, device=h.device)
                eid = torch.cat([idx, shared.expand(T, -1)], 1)
                wt = torch.cat([w, w.new_ones(T, s.shared_experts)], 1)
                p = M.plan(eid, s.experts + s.shared_experts)
                a, rw = M.gather(h, p), M.scatter_weights(wt, p)
                if self.routed_rows is None:
                    self.routed_rows = torch.zeros(s.experts, dtype=torch.int64, device=h.device)
                self.routed_rows += p.counts[: s.experts]
            with span("btia.lm.moe.experts", T):
                y = self.experts(a, p, rw)
            with span("btia.lm.moe.combine"):
                return M.combine(y, p)


class DenseMLP(SwiGLU):
    def __init__(self, s: LMSpec, dtype, device):
        super().__init__(1, s.dim, s.dense_width, dtype, device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return super().forward(h, M.single_group(h.shape[0], h.device))


class LMLayer(nn.Module):
    def __init__(self, s: LMSpec, dense: bool, policy: DTypePolicy, device):
        super().__init__()
        self.s = s
        dtype = policy.compute_dtype
        self.attn_norm = _Leaf("scale", s.dim, dtype=dtype, device=device)
        self.attn = MLA(s, policy, device)
        self.mlp_norm = _Leaf("scale", s.dim, dtype=dtype, device=device)
        self.mlp = DenseMLP(s, dtype, device) if dense else MoE(s, dtype, device)

    def forward(self, x, index, pos, mask):
        s, cd = self.s, x.dtype
        with span("btia.lm.attn"):
            a = self.attn(rms_norm(x, self.attn_norm.scale, s.rms_eps, cd), index, pos, mask)
        x = (x.float() + a.float()).to(cd)
        return (x.float() + self.mlp(rms_norm(x, self.mlp_norm.scale, s.rms_eps, cd)).float()).to(cd)


class MoELanguageModel(nn.Module):
    """WordPiece ids -> (the final RMSNorm's output (B, S, dim), mask)."""

    packs_tokens = True  # takes the real tokens' flat indices (token_index)

    def __init__(self, spec: LMSpec, policy: DTypePolicy, device=None):
        super().__init__()
        self.spec = spec
        self.policy = policy
        dt = policy.compute_dtype
        self.embed = _Leaf("embedding", spec.vocab_size, spec.dim, dtype=dt, device=device)
        for i in range(spec.layers):
            self.add_module(f"layer{i}", LMLayer(spec, i < spec.first_dense, policy, device))
        self.norm = _Leaf("scale", spec.dim, dtype=dt, device=device)

    @property
    def out_dim(self) -> int:
        return self.spec.dim

    def routed_rows(self) -> Optional[torch.Tensor]:
        """(MoE layers, experts) rows routed to each expert since the model
        was made (None before its first call); reading it waits for the card."""
        rows = [m.mlp.routed_rows for m in self.children() if isinstance(m, LMLayer) and isinstance(m.mlp, MoE)]
        return None if any(r is None for r in rows) else torch.stack(rows)

    def forward(self, token_ids: torch.Tensor, mask: Optional[torch.Tensor] = None, drop=None, train: bool = False,
                token_index: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if train or drop is not None:
            raise ValueError("the mla_moe question encoder serves only: no train forward")
        if mask is None:
            mask = token_ids > 0
        B, S = token_ids.shape
        if token_index is None:
            token_index = torch.nonzero(mask.reshape(-1)).squeeze(1)
        cd = self.policy.compute_dtype
        x = F.embedding(token_ids.reshape(-1)[token_index], self.embed.embedding).to(cd)
        pos = token_index % S
        for i in range(self.spec.layers):
            x = getattr(self, f"layer{i}")(x, token_index, pos, mask)
        x = rms_norm(x, self.norm.scale, self.spec.rms_eps, cd)
        out = x.new_zeros(B * S, self.spec.dim).index_copy_(0, token_index, x)
        return out.view(B, S, -1), mask
