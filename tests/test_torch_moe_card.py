"""On the card: the grouped expert GEMM (``csrc/moe_gemm.cu``, through
``ops/moe.py::grouped_gemm``) against its plain twin at the serve cell's
shapes, its time against a per-expert ``torch.mm`` loop, and one MoE layer
of ``models/mla_moe.py`` run with the host's synchronisation made an error.
Skipped without a card; run there with

    python -m pytest --noconftest -m chip tests/test_torch_moe_card.py -s

The shapes: ``kimivl-fanout-backlog`` launches 16 x 128 questions of 11.3
real tokens on average, ~23,000 tokens, each routed to 6 of 64 experts and
to the 2 shared ones, ~2,200 rows an expert at even load (here drawn
unevenly, as the router does); K 2,048 -> 2 x 1,408 (gate and up, SwiGLU in
the epilogue), then 1,408 -> 2,048 (each row times its routing weight)."""

import math

import pytest
import torch
import torch.nn.functional as F

from btia_tpu_torch.ops import moe as M

BF16 = torch.bfloat16
T, E, SHARED, TOP_K, D, I = 23000, 64, 2, 6, 2048, 1408


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 at each element's magnitude."""
    x = x.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def routed(dev, seed: int = 0):
    """A plan of T tokens over the experts (uneven: each expert's share
    lognormal) and the shared groups, its weights and permuted inputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    share = torch.exp(0.5 * torch.randn(E, generator=g, device=dev))
    idx = torch.multinomial(share.expand(T, E), TOP_K, generator=g)
    eid = torch.cat([idx, torch.arange(E, E + SHARED, device=dev).expand(T, SHARED)], 1)
    w = torch.cat([torch.rand(T, TOP_K, generator=g, device=dev), torch.ones(T, SHARED, device=dev)], 1)
    p = M.plan(eid, E + SHARED)
    x = torch.randn(T, D, generator=g, device=dev).to(BF16)
    return p, M.gather(x, p), M.scatter_weights(w, p), g


def weights(g, dev):
    G = E + SHARED
    gu = (torch.randn(G, D, 2 * I, generator=g, device=dev) * D**-0.5).to(BF16)
    dn = (torch.randn(G, I, D, generator=g, device=dev) * I**-0.5).to(BF16)
    return gu, dn


@pytest.mark.chip
@pytest.mark.parametrize("act", ["swiglu", None])
def test_grouped_gemm_against_its_twin_at_the_cells_shapes(card, act):
    """Every row of a block in use within one bf16 step of the twin (the
    same f32 function of the same bf16 operands), plus 2e-6 of the largest
    magnitude for every 768 of K: the tensor cores' f32 accumulation
    truncates and sums in another order, and SiLU takes ex2.approx and a
    fast divide (each ~1e-7 relative)."""
    p, a, rw, g = routed(card)
    gu, dn = weights(g, card)
    if act == "swiglu":
        w, scale, K = gu, None, D
    else:
        a = (torch.randn(p.rows, I, generator=g, device=card)).to(BF16)
        w, scale, K = dn, rw, I
    got = M.grouped_gemm(a, w, p, act, scale)
    want = M._grouped_plain(a, w, p, act, scale)
    rows = int(p.used[0]) * M.BLOCK
    got, want = got[:rows].float(), want[:rows].float()
    assert bool(torch.isfinite(got).all())
    floor = 2e-6 * max(1.0, K / 768) * want.abs().max()
    bad = (got - want).abs() > _bf16_step(want) + floor
    assert int(bad.sum()) == 0, (int(bad.sum()), float((got - want).abs().max()))


def _ms(fn, n: int = 20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


@pytest.mark.chip
def test_grouped_gemm_time_per_moe_layer(card):
    """A MoE layer's two grouped products against the per-expert loop of
    bf16 ``torch.mm`` with SiLU * up and the routing weight (the twin's
    structure on the library's GEMM), in turns in one process; the kernel
    no slower. Prints both, the bound (``portbench/flops_lm.py``'s rule:
    every group's weights and the rows in and out once, or the operations at
    989 TFLOP/s) and the kernel's share of it."""
    p, a, rw, g = routed(card, seed=1)
    gu, dn = weights(g, card)
    counts = p.counts.tolist()
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + -(-c // M.BLOCK) * M.BLOCK)

    def kernel():
        return M.grouped_gemm(M.grouped_gemm(a, gu, p, "swiglu"), dn, p, row_scale=rw)

    def loop():
        out = torch.empty(p.rows, D, dtype=BF16, device=card)
        for e, c in enumerate(counts):
            r = slice(starts[e], starts[e] + c)
            h = F.silu(torch.mm(a[r], gu[e, :, :I])) * torch.mm(a[r], gu[e, :, I:])
            out[r] = torch.mm(h, dn[e]) * rw[r, None]
        return out

    for f in (kernel, loop):
        f()
    times = {"kernel": [], "loop": []}
    for _ in range(3):
        for name, f in (("kernel", kernel), ("loop", loop), ("loop", loop), ("kernel", kernel)):
            times[name].append(_ms(f, 5))
    k_ms, l_ms = min(times["kernel"]), min(times["loop"])
    rows = T * (TOP_K + SHARED)
    ops = 2.0 * rows * D * 2 * I + 2.0 * rows * I * D
    byts = 2.0 * ((E + SHARED) * 3 * D * I + rows * (D + 2 * I + D))
    bound = max(ops / 989e12, byts / 3.35e12) * 1e3
    print(f"\nmoe layer, {T} tokens x {TOP_K} + {SHARED} groups, load max/mean "
          f"{max(counts[:E]) / (sum(counts[:E]) / E):.2f}: grouped GEMM {k_ms:.4f} ms, per-expert torch.mm loop "
          f"{l_ms:.4f} ms, bound {bound:.4f} ms ({'ops' if ops / 989e12 > byts / 3.35e12 else 'bytes'}), "
          f"roofline {100 * bound / k_ms:.1f} %; all: {times}")
    assert k_ms <= l_ms


@pytest.mark.chip
def test_a_moe_layer_runs_without_synchronising_the_host(card):
    """One MoE layer at the published widths, its forward under
    ``torch.cuda.set_sync_debug_mode("error")``, against the f32 reference
    of the same layer (``portbench/reference/lm.py``)."""
    from portbench.reference import lm as L
    from btia_tpu_torch.models.mla_moe import LMSpec, MoE

    s = LMSpec()
    layer = MoE(s, BF16, card)
    g = torch.Generator(device=card).manual_seed(2)
    with torch.no_grad():
        layer.router.kernel.copy_(torch.randn(D, E, generator=g, device=card) * D**-0.5)
        layer.correction_bias.zero_()
        layer.experts.gate_up.copy_(torch.randn(E + SHARED, D, 2 * I, generator=g, device=card) * D**-0.5)
        layer.experts.down.copy_(torch.randn(E + SHARED, I, D, generator=g, device=card) * I**-0.5)
    h = torch.randn(4000, D, generator=g, device=card).to(BF16)
    with torch.inference_mode():
        layer(h)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = layer(h)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    m = {"lm_experts": E, "lm_expert_width": I, "lm_experts_per_token": TOP_K, "lm_routed_scale": s.routed_scale}
    P = {f"l.{k}": v.float() for k, v in layer.state_dict().items()}
    want = L.moe(h.float(), P, "l", m)
    tok = (y.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(tok.median()) < 1e-2, float(tok.median())
    assert int(layer.routed_rows.sum()) == 2 * 4000 * TOP_K
    assert math.isfinite(float(y.float().abs().max()))
