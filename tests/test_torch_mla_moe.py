"""The ``mla_moe`` question encoder (``models/mla_moe.py``) and its MoE
layer's routing and grouped GEMM (``ops/moe.py``), on the CPU at a tiny
size: the whole ``BTIAADNet`` against the plain reference
(``portbench/reference/lm.py``, the LM; ``portbench/reference/model.py``, the
image side, BTIA and the AD head) on seeded weights, the routing against
the reference's, the permutation and the grouped GEMM's twin against a
per-expert loop, the config, ``init_params``, the Predictor's host-side
token index, and the published checkpoint's names (``convert/hf.py``).

Tolerances. f32: the LM's output within 1e-5 of the reference's norm
(measured 6e-7: only the order of sums differs), the logits within 1e-3
(measured 1.5-2e-4: the fusion sites' fast-variance LayerNorm and exp2
softmax, which the existing sites' tests hold to the JAX package). bf16:
each projection's output is rounded to bf16 (2^-9 relative) about ten times
a layer, and where two experts' router scores lie within that rounding the
program routes a token elsewhere than the f32 reference, which changes that
token's output by O(1) (the published code routes from the same bf16
hidden states): the median token within 3e-2 (measured 1.2-1.4 %), the
90th percentile within 0.1 (1.9-6.7 %), the logits' Frobenius error within
0.15 (1.7-8.1 %), over four seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from btia_tpu_torch import get_config
from btia_tpu_torch.configs.config import Config
from btia_tpu_torch.convert.hf import kimi_lm_params_from_hf
from btia_tpu_torch.models import mla_moe
from btia_tpu_torch.models.model import BTIAADNet, init_params
from btia_tpu_torch.ops import moe as M
from portbench.reference import lm as L
from portbench.reference import model as R

TINY = {"model.image_encoder": "vit_test", "model.hidden_dim": 64, "model.num_heads": 2, "model.btia_layers": 1,
        "model.answer_vocab_size": 32, "model.num_answer_queries": 8, "model.max_question_len": 12,
        "model.lm_layers": 4, "model.lm_hidden": 64, "model.lm_heads": 4, "model.lm_vocab_size": 300,
        "model.lm_dense_width": 96, "model.lm_expert_width": 32, "model.lm_experts": 8,
        "model.lm_shared_experts": 1, "model.lm_experts_per_token": 2, "model.lm_kv_lora_rank": 16,
        "model.lm_qk_nope_dim": 16, "model.lm_qk_rope_dim": 8, "model.lm_v_dim": 16}


def tiny(mixed: bool, seed: int = 0, **kw):
    cfg = get_config("streaming_kimivl", **TINY, **{"model.mixed_precision": mixed}, **kw)
    model = BTIAADNet(cfg.model, device="cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("correction_bias"):  # init_params's zero leaves its path unexercised
                p.normal_(0.0, 0.3, generator=g)
    return cfg, model.eval()


def question_ids(seed: int, n: int = 16, S: int = 12, vocab: int = 300) -> torch.Tensor:
    """n questions of 3..S real ids, padding 0 at the end (as WordPiece)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros(n, S, dtype=torch.long)
    for i, k in enumerate(torch.randint(3, S + 1, (n,), generator=g).tolist()):
        ids[i, :k] = torch.randint(1, vocab, (k,), generator=g)
    return ids


def reference_logits(model, cfg, imgs, ids):
    m = dataclasses.asdict(cfg.model)
    P = {k: v.float() for k, v in model.state_dict().items()}
    lm = L.encode(ids, P, m)
    img = R.encode_image(imgs, P, m)
    txt = R.layer_norm(R.dense(lm, P, "txt_proj"), P, "txt_ln", 1e-6)
    return lm, R.fuse_and_answer(img.expand(ids.shape[0], *img.shape[1:]), txt, ids > 0, P, m)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mixed", [False, True])
def test_model_matches_the_reference(mixed, seed):
    cfg, model = tiny(mixed, seed)
    ids = question_ids(seed + 3)
    imgs = torch.randint(0, 256, (1, 96, 96, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got, mask = model.question_encoder(ids)
        logits = model.answer_questions(model.encode_image(imgs), ids[None])[0].float()
        want, ref = reference_logits(model, cfg, imgs, ids)
    got = got.float()
    assert bool((got[~mask] == 0).all())
    rel = lambda a, b: float((a - b).norm() / b.norm())
    if not mixed:
        assert rel(got, want) < 1e-5
        assert rel(logits, ref) < 1e-3
    else:
        tok = (got - want).norm(dim=-1)[mask] / want.norm(dim=-1)[mask]
        assert float(tok.median()) < 3e-2 and float(tok.quantile(0.9)) < 0.1
        assert rel(logits, ref) < 0.15
        assert all(p.dtype == torch.bfloat16 for n, p in model.question_encoder.named_parameters()
                   if not n.endswith("bias"))


def test_routing_equals_the_references():
    cfg, model = tiny(False)
    m = dataclasses.asdict(cfg.model)
    P = {k: v.float() for k, v in model.state_dict().items()}
    h = torch.randn(200, 64, generator=torch.Generator().manual_seed(5))
    for i in range(1, 4):
        idx, w = getattr(model.question_encoder, f"layer{i}").mlp.route(h)
        ridx, rw = L.route(h, P, f"question_encoder.layer{i}.mlp", m)
        assert torch.equal(idx, ridx)
        assert torch.allclose(w, rw, atol=1e-6)
        assert torch.allclose(w.sum(-1), torch.full((200,), m["lm_routed_scale"]), atol=1e-5)


def test_only_real_tokens_are_routed_and_counted():
    cfg, model = tiny(True)
    ids = question_ids(7)
    ids[4] = 0  # an all-padding question, as a bucket's filler row
    seen = []
    real_plan = M.plan
    M.plan = lambda eid, G: seen.append(eid.shape[0]) or real_plan(eid, G)
    try:
        with torch.no_grad():
            model.question_encoder(ids)
            model.question_encoder(ids[:3])
    finally:
        M.plan = real_plan
    n_real = int((ids > 0).sum()) + int((ids[:3] > 0).sum())
    assert sum(seen) == 3 * n_real  # three MoE layers
    rows = model.question_encoder.routed_rows()
    assert rows.shape == (3, 8)
    assert rows.sum(1).tolist() == [2 * n_real] * 3


def test_token_index_from_the_host_gives_the_same_output():
    cfg, model = tiny(False)
    ids = question_ids(8)
    with torch.no_grad():
        a, _ = model.question_encoder(ids)
        b, _ = model.question_encoder(ids, token_index=torch.from_numpy(np.flatnonzero(ids.numpy() > 0)))
    assert torch.equal(a, b)


def test_a_train_forward_raises():
    cfg, model = tiny(False)
    with pytest.raises(ValueError, match="serves only"):
        model.question_encoder(question_ids(1), train=True)


@pytest.mark.parametrize("mixed", [False, True])
def test_predictor_hands_the_token_index_over(mixed):
    from btia_tpu_torch import Predictor
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer

    cfg, model = tiny(mixed)
    qs = ["is the lung normal", "which side is the lesion on", "what organ is shown"]
    pred = Predictor(model, None, WordPieceTokenizer.toy_vocab(qs), AnswerVocab(["yes", "no", "left"]), cfg,
                     device="cpu")
    got = []
    forward = model.question_encoder.forward
    model.question_encoder.forward = lambda *a, **k: got.append(k.get("token_index")) or forward(*a, **k)
    img = np.random.RandomState(0).randint(0, 256, (120, 90, 3), dtype=np.uint8)
    logits = pred.predict_batch(img, qs)
    ids = pred._tokenize(qs)
    assert logits.shape == (3, 32) and np.isfinite(logits).all()
    qids = np.zeros((1, 4, 12), np.int64)  # bucketed to 4 questions
    qids[0, :3] = ids
    assert np.array_equal(got[0].numpy(), np.flatnonzero(qids > 0))


def test_plan_places_each_group_in_blocks():
    g = torch.Generator().manual_seed(0)
    T, k, G = 300, 3, 9
    eid = torch.stack([torch.randperm(G - 1, generator=g)[:k] for _ in range(T)])  # group 8 gets no row
    p = M.plan(eid, G)
    dest = p.dest.reshape(-1)
    assert dest.unique().numel() == T * k and p.rows % M.BLOCK == 0
    counts = torch.bincount(eid.reshape(-1), minlength=G)
    assert torch.equal(p.counts, counts)
    starts = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum((counts + 127) // 128 * 128, 0)[:-1]])
    for e in range(G):
        rows = dest[eid.reshape(-1) == e]
        # each group's rows in (token, slot) order from its block-aligned start
        assert torch.equal(rows, starts[e] + torch.arange(int(counts[e])))
        blocks = range(int(starts[e]) // 128, int(starts[e] + (counts[e] + 127) // 128 * 128) // 128)
        assert all(int(p.blk_group[b]) == e for b in blocks)
    assert int(p.used[0]) == int(((counts + 127) // 128).sum())
    assert bool((p.blk_group[int(p.used[0]):] == G).all())
    x = torch.randn(T, 5, generator=g)
    a = M.gather(x, p)
    assert torch.equal(a[dest], x.repeat_interleave(k, 0))
    pad = torch.ones(p.rows, dtype=torch.bool)
    pad[dest] = False
    assert bool((a[pad] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_twin_equals_a_per_expert_loop(dtype):
    """plan -> gather -> grouped GEMM (SwiGLU, then the down product with
    the routing weights) -> combine, against each token's experts computed
    one at a time and summed (f32 products of the same operands; under bf16
    the loop rounds where the twin does, but its f32 sums run in another
    order, so a rounded term may land one bf16 step (2^-8 relative) away:
    within 1e-2 then)."""
    g = torch.Generator().manual_seed(1)
    T, D, I, E, S, k = 257, 32, 128, 6, 1, 2
    x = torch.randn(T, D, generator=g).to(dtype)
    gu = (torch.randn(E + S, D, 2 * I, generator=g) / D**0.5).to(dtype)
    dn = (torch.randn(E + S, I, D, generator=g) / I**0.5).to(dtype)
    idx = torch.stack([torch.randperm(E - 1, generator=g)[:k] for _ in range(T)])  # expert E - 1 idle
    w = torch.rand(T, k, generator=g)
    eid = torch.cat([idx, torch.full((T, S), E)], 1)
    wt = torch.cat([w, torch.ones(T, S)], 1)
    p = M.plan(eid, E + S)
    h = M.grouped_gemm(M.gather(x, p), gu, p, "swiglu")
    got = M.combine(M.grouped_gemm(h, dn, p, row_scale=M.scatter_weights(wt, p)), p)
    want = torch.zeros(T, D)
    for t in range(T):
        for j in range(k + S):
            e = int(eid[t, j])
            acc = x[t].float() @ gu[e].float()
            mid = (torch.nn.functional.silu(acc[:I]) * acc[I:]).to(dtype)
            want[t] += ((mid.float() @ dn[e].float()) * wt[t, j]).to(dtype).float()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert torch.allclose(got, want, rtol=tol, atol=tol)


def test_grouped_gemm_refuses_an_act_with_a_row_scale():
    p = M.single_group(4, "cpu")
    with pytest.raises(ValueError):
        M.grouped_gemm(torch.zeros(4, 8), torch.zeros(1, 8, 256), p, "swiglu", row_scale=torch.ones(4))


def test_config_json():
    cfg = get_config("streaming_kimivl")
    assert Config.from_json(cfg.to_json()) == cfg
    m = cfg.model
    assert (m.question_encoder, m.lm_layers, m.lm_hidden, m.lm_experts, m.lm_experts_per_token) == ("mla_moe", 27, 2048,
                                                                                                    64, 6)
    for name in ("streaming_vitl", "vqa_med_full", "tiny_test", "slake_bert"):
        assert "lm_" not in get_config(name).to_json()


def test_the_registered_config_builds_at_full_size():
    """On ``meta``: shapes only. 15.62 B parameters in the language model."""
    model = BTIAADNet(get_config("streaming_kimivl").model, device="meta")
    n = sum(p.numel() for p in model.question_encoder.parameters())
    assert 15.6e9 < n < 15.65e9
    assert model.txt_proj.kernel.shape == (2048, 768)


def test_reference_weights_load_into_the_program():
    cfg, model = tiny(True)
    m = dataclasses.asdict(cfg.model)
    W = L.make_weights(m, 2**31 + 5, "cpu")
    model.load_state_dict(W, strict=False)
    own = model.question_encoder.state_dict()
    assert sorted("question_encoder." + k for k in own) == sorted(W)
    lw = L.LayerWeights(m, 2**31 + 5, "cpu")
    for name, t in W.items():
        assert torch.equal(lw[name], t.float())


def test_published_checkpoint_names_map_onto_the_port():
    """A state dict with the published names (Kimi-VL's language_model.*,
    (out, in) weights, the shared experts one SwiGLU) at the tiny size,
    converted and loaded, gives the tensors back where the port keeps them."""
    cfg, model = tiny(False)
    s = mla_moe.LMSpec.of(cfg.model)
    g = torch.Generator().manual_seed(9)
    r = lambda *shape: torch.randn(*shape, generator=g)
    H, dqk, I, W = s.heads, s.qk_nope_dim + s.qk_rope_dim, s.expert_width, s.dense_width
    sd = {"language_model.model.embed_tokens.weight": r(s.vocab_size, s.dim),
          "language_model.model.norm.weight": r(s.dim), "language_model.lm_head.weight": r(s.vocab_size, s.dim)}
    for i in range(s.layers):
        b = f"language_model.model.layers.{i}"
        sd.update({f"{b}.input_layernorm.weight": r(s.dim), f"{b}.post_attention_layernorm.weight": r(s.dim),
                   f"{b}.self_attn.q_proj.weight": r(H * dqk, s.dim),
                   f"{b}.self_attn.kv_a_proj_with_mqa.weight": r(s.kv_lora_rank + s.qk_rope_dim, s.dim),
                   f"{b}.self_attn.kv_a_layernorm.weight": r(s.kv_lora_rank),
                   f"{b}.self_attn.kv_b_proj.weight": r(H * (s.qk_nope_dim + s.v_dim), s.kv_lora_rank),
                   f"{b}.self_attn.o_proj.weight": r(s.dim, H * s.v_dim)})
        if i < s.first_dense:
            sd.update({f"{b}.mlp.gate_proj.weight": r(W, s.dim), f"{b}.mlp.up_proj.weight": r(W, s.dim),
                       f"{b}.mlp.down_proj.weight": r(s.dim, W)})
            continue
        sd.update({f"{b}.mlp.gate.weight": r(s.experts, s.dim), f"{b}.mlp.gate.e_score_correction_bias": r(s.experts)})
        for e in range(s.experts):
            for n, shape in (("gate_proj", (I, s.dim)), ("up_proj", (I, s.dim)), ("down_proj", (s.dim, I))):
                sd[f"{b}.mlp.experts.{e}.{n}.weight"] = r(*shape)
        SI = s.shared_experts * I
        for n, shape in (("gate_proj", (SI, s.dim)), ("up_proj", (SI, s.dim)), ("down_proj", (s.dim, SI))):
            sd[f"{b}.mlp.shared_experts.{n}.weight"] = r(*shape)
    sd["vision_tower.patch_embed.proj.weight"] = r(4, 3)  # not the language model's: left out
    params = kimi_lm_params_from_hf(sd, s)
    model.question_encoder.load_state_dict(params, strict=True)
    qe = model.question_encoder
    b = "language_model.model.layers"
    assert torch.equal(qe.embed.embedding, sd["language_model.model.embed_tokens.weight"])
    assert torch.equal(qe.layer0.attn.kv_a_proj.kernel, sd[f"{b}.0.self_attn.kv_a_proj_with_mqa.weight"].T)
    assert not qe.layer1.attn.o_proj.bias.any() and qe.layer1.attn.o_proj.bias.dtype == torch.float32
    assert torch.equal(qe.layer0.mlp.gate_up[0, :, W:], sd[f"{b}.0.mlp.up_proj.weight"].T)
    assert torch.equal(qe.layer2.mlp.correction_bias, sd[f"{b}.2.mlp.gate.e_score_correction_bias"])
    assert torch.equal(qe.layer2.mlp.router.kernel, sd[f"{b}.2.mlp.gate.weight"].T)
    assert torch.equal(qe.layer2.mlp.experts.gate_up[5, :, :I], sd[f"{b}.2.mlp.experts.5.gate_proj.weight"].T)
    assert torch.equal(qe.layer2.mlp.experts.down[3], sd[f"{b}.2.mlp.experts.3.down_proj.weight"].T)
    shared = sd[f"{b}.2.mlp.shared_experts.up_proj.weight"]
    assert torch.equal(qe.layer2.mlp.experts.gate_up[s.experts, :, I:], shared[:I].T)
    assert torch.equal(qe.layer2.mlp.experts.down[s.experts], sd[f"{b}.2.mlp.shared_experts.down_proj.weight"][:, :I].T)
    # the published layer's function: the shared experts as one SwiGLU
    x = r(5, s.dim)
    F = torch.nn.functional
    one = F.silu(x @ sd[f"{b}.2.mlp.shared_experts.gate_proj.weight"].T) * (x @ shared.T)
    one = one @ sd[f"{b}.2.mlp.shared_experts.down_proj.weight"].T
    groups = sum(F.silu(x @ qe.layer2.mlp.experts.gate_up[g, :, :I]) * (x @ qe.layer2.mlp.experts.gate_up[g, :, I:])
                 @ qe.layer2.mlp.experts.down[g] for g in range(s.experts, s.experts + s.shared_experts))
    assert torch.allclose(one, groups, atol=1e-4)
    with pytest.raises(KeyError):
        kimi_lm_params_from_hf({"language_model.model.layers.0.self_attn.q_a_proj.weight": r(2, 2)}, s)
