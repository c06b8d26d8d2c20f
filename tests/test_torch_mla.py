"""The MLA's attention core (``ops/mla.py``) on the CPU: its plain twin,
through ``models/mla_moe.py::MLA.forward``, bit-equal to the grid code the
layer ran before it (kept here verbatim as ``grid_forward``), and the layer
against the plain reference's MLA (``portbench/reference/lm.py::mla``) on the
same weights; then the route, which sends CPU tensors, f32 tensors, widths
past the kernel's and S past its window to the twin.

Cases: questions of one real token and of S; a question with a padding id
inside; T not a multiple of the kernel's 64-row items; S = 32 (the serve
cell's) and a small S. Tolerances against the reference: f32 within 1e-5
of its norm (measured 0.8-1.3e-7: only the order of sums differs); bf16
the median token within 2e-2 and every token within 5e-2: the program
rounds q, [c | k_pe], the normed latent, [k_nope | v], the rotary parts,
the probabilities and o to bf16 (2^-9 relative each) where the reference
keeps f32 (measured: median 4.0-4.6e-3, largest 6.5-8.4e-3).
"""

import math

import pytest
import torch

from btia_tpu_torch.core.dtypes import default_policy
from btia_tpu_torch.models import mla_moe
from btia_tpu_torch.ops import mla as A
from portbench.reference import lm as L

DIM, HEADS, DN, DR, DV, RANK = 64, 4, 16, 8, 16, 16


def grid_forward(self, h, index, pos, mask):
    """``MLA.forward`` as it was before the core moved to ``ops/mla.py``:
    the yardstick the twin is held to, bit for bit."""
    s = self.s
    T, (B, S) = h.shape[0], mask.shape
    H, dn, dr, dv, r = s.heads, s.qk_nope_dim, s.qk_rope_dim, s.v_dim, s.kv_lora_rank
    cd = h.dtype
    q = self.q_proj(h).view(T, H, dn + dr)
    ckv = self.kv_a_proj(h)
    kv = self.kv_b_proj(mla_moe.rms_norm(ckv[:, :r], self.kv_norm.scale, s.rms_eps, cd)).view(T, H, dn + dv)
    k_pe = mla_moe.rope(ckv[:, None, r:], pos, s.rope_theta).expand(T, H, dr)
    qg = h.new_zeros(B * S, H, dn + dr)
    kg = h.new_zeros(B * S, H, dn + dr)
    vg = h.new_zeros(B * S, H, dv)
    qg[index] = torch.cat([q[..., :dn], mla_moe.rope(q[..., dn:], pos, s.rope_theta)], -1)
    kg[index] = torch.cat([kv[..., :dn], k_pe], -1)
    vg[index] = kv[..., dn:]
    heads = lambda t: t.view(B, S, H, -1).transpose(1, 2)
    scores = heads(qg).float() @ heads(kg).float().transpose(-1, -2) / math.sqrt(dn + dr)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    allowed = causal[None, None] & mask[:, None, None, :]
    probs = torch.softmax(scores.masked_fill(~allowed, torch.finfo(torch.float32).min), -1)
    o = (probs.to(cd) @ heads(vg)).transpose(1, 2).reshape(B * S, H * dv)
    return self.o_proj(o[index])


def lengths_of(case: str, g: torch.Generator):
    """(S, real ids a question) of each case."""
    if case == "one_and_full":
        return 32, [1, 32, 1, 1, 32, 32, 5, 1]
    if case == "ragged_rows":  # 7-16 ids a question (the serve cell's), T = 203
        lens = torch.randint(7, 17, (40,), generator=g).tolist()
        while sum(lens) > 203:
            lens.pop()
        return 32, lens + [203 - sum(lens)]
    if case in ("zero_inside", "small_s"):
        return 5, [1, 5, 3, 4, 2, 5, 5, 1, 4]
    raise KeyError(case)


def batch(case: str, seed: int):
    """ids (B, S), their mask and flat real indices; zero_inside puts a
    padding id inside two questions."""
    g = torch.Generator().manual_seed(seed)
    S, lens = lengths_of(case, g)
    ids = torch.zeros(len(lens), S, dtype=torch.long)
    for i, k in enumerate(lens):
        ids[i, :k] = torch.randint(1, 300, (k,), generator=g)
    if case == "zero_inside":
        ids[1, 2] = 0
        ids[5, 1] = 0
    mask = ids > 0
    return ids, mask, torch.nonzero(mask.reshape(-1)).squeeze(1)


def mla_layer(mixed: bool, seed: int):
    s = mla_moe.LMSpec(dim=DIM, heads=HEADS, kv_lora_rank=RANK, qk_nope_dim=DN, qk_rope_dim=DR, v_dim=DV)
    layer = mla_moe.MLA(s, default_policy(mixed), "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=g) * p.shape[0] ** -0.5)
            else:  # Dense's f32 bias, zero as the published model has none
                p.zero_()
    return s, layer


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("case", ["one_and_full", "zero_inside", "ragged_rows", "small_s"])
def test_the_twin_is_the_grid_code_and_the_layer_matches_the_reference(case, mixed):
    ids, mask, index = batch(case, seed=len(case))
    s, layer = mla_layer(mixed, seed=len(case) + mixed)
    T, S = index.numel(), ids.shape[1]
    assert case != "ragged_rows" or T % 64
    cd = default_policy(mixed).compute_dtype
    h = torch.randn(T, DIM, generator=torch.Generator().manual_seed(7)).to(cd)
    pos = index % S
    with torch.no_grad():
        got = layer(h, index, pos, mask)
        assert torch.equal(got, grid_forward(layer, h, index, pos, mask))
        assert mla_attention_calls_the_twin(layer, h, index, pos, mask)
        m = {"lm_heads": HEADS, "lm_qk_nope_dim": DN, "lm_qk_rope_dim": DR, "lm_v_dim": DV, "lm_kv_lora_rank": RANK,
             "lm_rms_eps": s.rms_eps, "lm_rope_theta": s.rope_theta}
        P = {f"a.{k}": v.float() for k, v in layer.state_dict().items()}
        x = torch.zeros(mask.numel(), DIM).index_copy(0, index, h.float()).view(*mask.shape, DIM)
        want = L.mla(x, mask, P, "a", m).reshape(-1, DIM)[index]
    got = got.float()
    if not mixed:
        assert float((got - want).norm() / want.norm()) < 1e-5
    else:
        tok = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert float(tok.median()) < 2e-2 and float(tok.max()) < 5e-2, (float(tok.median()), float(tok.max()))


def mla_attention_calls_the_twin(layer, h, index, pos, mask) -> bool:
    """The layer's core went through ``mla_attention`` and its twin, and
    launched nothing."""
    seen, before = [], A.mla_attention.launches
    plain = A._mla_plain
    A._mla_plain = lambda *a: seen.append(1) or plain(*a)
    try:
        layer(h, index, pos, mask)
    finally:
        A._mla_plain = plain
    return seen == [1] and A.mla_attention.launches == before


def operands(dtype, T=12, H=2, dn=128, dr=64, dv=128, S=4):
    g = torch.Generator().manual_seed(T + dn + S)
    mask = torch.zeros(-(-T // S), S, dtype=torch.bool).view(-1)
    mask[:T] = True
    mask = mask.view(-1, S)
    index = torch.nonzero(mask.reshape(-1)).squeeze(1)
    mk = lambda *shape: torch.randn(*shape, generator=g).to(dtype)
    return mk(T, H, dn + dr), mk(T, H, dn + dv), mk(T, H, dr), mk(T, 1, dr), index, mask


@pytest.mark.parametrize("dtype, widths, S, reason", [
    (torch.bfloat16, (128, 64, 128), 32, "device"),  # the published widths, on the CPU
    (torch.float32, (128, 64, 128), 32, "dtype"),
    (torch.bfloat16, (192, 64, 128), 32, "widths"),
    (torch.bfloat16, (128, 64, 136), 8, "widths"),
    (torch.bfloat16, (20, 8, 16), 8, "widths"),  # not multiples of 8
    (torch.bfloat16, (16, 8, 16), 33, "S"),
])
def test_the_route_sends_what_the_kernel_does_not_take_to_the_twin(dtype, widths, S, reason):
    dn, dr, dv = widths
    q, kv, q_pe, k_pe, index, mask = operands(dtype, dn=dn, dr=dr, dv=dv, S=S)
    assert A.kernel_refuses(q, kv, q_pe, k_pe, mask).startswith(reason)
    before = A.mla_attention.launches
    got = A.mla_attention(q, kv, q_pe, k_pe, index, mask)
    assert A.mla_attention.launches == before
    assert torch.equal(got, A._mla_plain(q, kv, q_pe, k_pe, index, mask))
    assert got.shape == (q.shape[0], q.shape[1] * dv) and got.dtype == dtype
