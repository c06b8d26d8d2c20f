"""On the card: the MLA attention core (``csrc/mla_attn.cu``, through
``ops/mla.py::mla_attention``) against its plain twin at the serve cell's
shapes, its C entry's time against the bytes bound, one ``LMLayer`` of
``models/mla_moe.py`` run with the host's synchronisation made an error, and
the kernel's launches in a 27-layer forward. Skipped without a card; run
there with

    python -m pytest --noconftest -m chip tests/test_torch_mla_card.py -s

The shapes: ``kimivl-fanout-backlog`` launches 16 x 128 = 2,048 questions of
S = 32 ids, 7-16 of them real (WordPiece lengths), ~23,100 real tokens; 16
heads, q_nope 128 + q_pe 64, v 128. Here lengths of 1 and of 32 are mixed
in, and one question has a padding id inside."""

import ctypes
import math

import pytest
import torch

from btia_tpu_torch.core.dtypes import BF16_POLICY
from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops import mla as A

BF16 = torch.bfloat16
B, S, H, DN, DR, DV = 2048, 32, 16, 128, 64, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 at each element's magnitude."""
    x = x.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def cell_inputs(dev, seed: int = 0):
    """The operands of one layer's core at the cell's shapes: question
    lengths 7-16, with lengths 1 and 32 among them and a padding id inside
    one question; q, [k_nope | v], q_pe and k_pe drawn so that a score's
    scale is ~1 (softmax rows neither flat nor one-hot)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(7, 17, (B,), generator=g, device=dev)
    lengths[:8] = torch.tensor([1, 32, 1, 32, 16, 7, 32, 1], device=dev)
    mask = torch.arange(S, device=dev)[None] < lengths[:, None]
    mask[4, 3] = False  # a padding id inside a question
    index = torch.nonzero(mask.reshape(-1)).squeeze(1)
    T = index.numel()
    q = torch.randn(T, H, DN + DR, generator=g, device=dev).to(BF16)
    kv = torch.randn(T, H, DN + DV, generator=g, device=dev).to(BF16)
    q_pe = torch.randn(T, H, DR, generator=g, device=dev).to(BF16)
    k_pe = torch.randn(T, 1, DR, generator=g, device=dev).to(BF16)
    return q, kv, q_pe, k_pe, index, mask


@pytest.mark.chip
def test_kernel_against_its_twin_at_the_cells_shapes(card):
    """Every element within one bf16 step of the twin, plus 2^-8 of the
    largest |v|: the scores' f32 sums are taken in another order (wgmma's
    against cuBLAS's), and the softmax's and P V's from the query back, so
    a probability near a bf16 rounding boundary may round to its neighbour,
    a change of at most 2^-8 (its ulp below 1) times its value's magnitude
    in o, and o's own rounding may flip (one step)."""
    q, kv, q_pe, k_pe, index, mask = cell_inputs(card)
    assert A.kernel_refuses(q, kv, q_pe, k_pe, mask) is None
    before = A.mla_attention.launches
    got = A.mla_attention(q, kv, q_pe, k_pe, index, mask).float()
    assert A.mla_attention.launches == before + 1
    want = A._mla_plain(q, kv, q_pe, k_pe, index, mask).float()
    assert got.shape == want.shape == (index.numel(), H * DV)
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    vmax = kv[..., DN:].float().abs().max()
    bad = diff > _bf16_step(want) + 2.0**-8 * vmax
    print(f"\nmla core, T {index.numel()}: max |kernel - twin| {float(diff.max()):.4g}, beyond one bf16 step "
          f"{int((diff > _bf16_step(want)).sum())} of {diff.numel()}, beyond the limit {int(bad.sum())}")
    assert int(bad.sum()) == 0, (int(bad.sum()), float(diff.max()))
    # a question of one token attends to itself alone: o is its own v
    first = index.tolist().index(0)
    assert torch.equal(got[first].view(H, DV), kv[first, :, DN:].float())


@pytest.mark.chip
@pytest.mark.parametrize("shift", [1, 5, 37])
def test_a_question_gives_the_same_bits_wherever_the_batch_packs_it(card, shift):
    """The same questions behind `shift` more real tokens (questions of
    that many ids in all put first): every packed row at another offset in
    its 64-row item and its 96-key window, and the output equal bit for bit.
    The language model is chaotic, so an ulp that depends on the batch would
    move answers (the serve cell's check re-runs questions in other
    batches)."""
    q, kv, q_pe, k_pe, index, mask = cell_inputs(card, seed=6)
    g = torch.Generator(device=card).manual_seed(shift)
    extra = lambda x: torch.cat([torch.randn(shift, *x.shape[1:], generator=g, device=card).to(BF16), x])
    lead = torch.arange(S, device=card)[None] < torch.tensor([S] * (shift // S) + [shift % S], device=card)[:, None]
    mask2 = torch.cat([lead, mask])
    index2 = torch.nonzero(mask2.reshape(-1)).squeeze(1)
    got = A.mla_attention(q, kv, q_pe, k_pe, index, mask)
    got2 = A.mla_attention(extra(q), extra(kv), extra(q_pe), extra(k_pe), index2, mask2)
    assert torch.equal(got2[shift:], got)


def _ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


@pytest.mark.chip
def test_c_entry_time_against_the_bytes_bound(card):
    """The C entry alone (the operands prepared as the wrapper prepares
    them) at ~23,100 tokens, beside the wrapper and the twin, against the
    bytes bound of 0.128 ms: at most 0.32 ms (40 % of the bound)."""
    q, kv, q_pe, k_pe, index, mask = cell_inputs(card, seed=1)
    T = index.numel()
    o = torch.empty(T, H * DV, dtype=BF16, device=card)
    k2 = k_pe.reshape(T, DR)
    strides = (ctypes.c_longlong * 9)(q.stride(0), q.stride(1), q_pe.stride(0), q_pe.stride(1), kv.stride(0),
                                      kv.stride(1), k2.stride(0), H * DV, DV)
    lib, stream = _native.lib(), _native.stream(q)

    def entry():
        _native.check(lib.btia_mla_attn(q.data_ptr(), q_pe.data_ptr(), kv.data_ptr(), k2.data_ptr(), o.data_ptr(),
                                        index.data_ptr(), strides, T, H, S, DN, DR, DV, (DN + DR) ** -0.5, stream),
                      "btia_mla_attn")

    wrapper = lambda: A.mla_attention(q, kv, q_pe, k_pe, index, mask)
    twin = lambda: A._mla_plain(q, kv, q_pe, k_pe, index, mask)
    times = {"entry": [], "wrapper": []}
    for _ in range(3):
        for name, f in (("entry", entry), ("wrapper", wrapper), ("wrapper", wrapper), ("entry", entry)):
            times[name].append(_ms(f))
    twin_ms = _ms(twin, 3)
    nbytes = 2 * T * (H * DN + H * DR + H * (DN + DV) + DR + H * DV) + 8 * T
    bound = nbytes / 3.35e12 * 1e3
    e_ms = min(times["entry"])
    print(f"\nmla core, T {T}: C entry {e_ms:.4f} ms, wrapper {min(times['wrapper']):.4f} ms, twin {twin_ms:.4f} ms, "
          f"bytes bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB), roofline {100 * bound / e_ms:.1f} %; all {times}")
    assert e_ms <= 0.32


def _init(module, g, dev):
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g, device=dev))
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p.shape[-2] if p.dim() >= 2 and not name.endswith("embedding") else 1
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * fan_in**-0.5)


@pytest.mark.chip
def test_an_lm_layer_runs_without_synchronising_the_host(card, monkeypatch):
    """One MoE LMLayer at the published widths on the cell's packed tokens,
    its forward under ``torch.cuda.set_sync_debug_mode("error")``, one
    kernel launch, within 2 % (the median token) of the same layer with the
    twin as its core."""
    from btia_tpu_torch.models import mla_moe
    from btia_tpu_torch.models.mla_moe import LMLayer, LMSpec

    s = LMSpec()
    layer = LMLayer(s, False, BF16_POLICY, card)
    g = torch.Generator(device=card).manual_seed(3)
    _init(layer, g, card)
    _, _, _, _, index, mask = cell_inputs(card, seed=2)
    x = torch.randn(index.numel(), s.dim, generator=g, device=card).to(BF16)
    pos = index % S
    with torch.inference_mode():
        layer(x, index, pos, mask)
        torch.cuda.synchronize()
        before = A.mla_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = layer(x, index, pos, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert A.mla_attention.launches == before + 1
        monkeypatch.setattr(mla_moe, "mla_attention", A._mla_plain)
        want = layer(x, index, pos, mask)
    tok = (y.float() - want.float()).norm(dim=-1) / (want.float() - x.float()).norm(dim=-1)
    assert math.isfinite(float(y.float().abs().max()))
    assert float(tok.median()) < 2e-2, float(tok.median())


@pytest.mark.chip
def test_a_forward_launches_the_kernel_once_a_layer(card):
    """A 27-layer language model with the published attention widths (the
    other widths cut, so it builds in seconds) launches the kernel 27 times
    a forward of the cell's 2,048 questions."""
    from btia_tpu_torch.models.mla_moe import LMSpec, MoELanguageModel

    s = LMSpec(dim=512, vocab_size=1000, dense_width=1024, expert_width=256, experts=8, shared_experts=1,
               experts_per_token=2, kv_lora_rank=128)
    model = MoELanguageModel(s, BF16_POLICY, card)
    _init(model, torch.Generator(device=card).manual_seed(4), card)
    _, _, _, _, index, mask = cell_inputs(card, seed=5)
    ids = torch.where(mask, torch.randint(1, s.vocab_size, mask.shape, device=card), 0)
    with torch.inference_mode():
        model(ids, token_index=index)
        before = A.mla_attention.launches
        out, _ = model(ids, token_index=index)
        torch.cuda.synchronize()
    assert A.mla_attention.launches - before == 27 == s.layers
    assert bool(torch.isfinite(out.float()).all())
