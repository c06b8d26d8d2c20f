"""The yardstick's arithmetic: the chip's published peaks and the operations
and bytes of the configurations' work, counted from the configuration's
shapes alone (a product of (m, k) by (k, n) is 2mkn operations), so that a
change to the program cannot change the count.

Counted: every projection, FFN product, the patch embedding, each score
(QK^T) and PV product, and the answer scoring; not the LayerNorms, softmax,
GELU, casts or the ingest resize. Peaks: NVIDIA H100 SXM data sheet, dense.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# name: (image size, patch, width, depth)
VIT = {"vit_b16": (224, 16, 768, 12), "vit_l336": (336, 14, 1024, 24), "vit_test": (96, 8, 64, 2)}


def _mm(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def _attn(sq: int, sk: int, d: int, project_q: bool = True) -> float:
    """The k, v, o (and q) projections at width d, the scores and PV."""
    f = _mm(sk, d, 2 * d) + _mm(sq, d, d) * (2 if project_q else 1)
    return f + 2 * _mm(sq, d, sk)


def vit_flops(m: dict) -> float:
    """One image through the ViT, pooling and img_proj."""
    size, p, d, depth = VIT[m["image_encoder"]]
    n = (size // p) ** 2 + 1
    f = _mm(n - 1, p * p * 3, d)
    f += depth * (_attn(n, n, d) + _mm(n, d, 4 * d) + _mm(n, 4 * d, d))
    return f + _mm(fused_image_tokens(m), d, m["hidden_dim"])


def fused_image_tokens(m: dict) -> int:
    size, p, _, _ = VIT[m["image_encoder"]]
    g, gt = size // p, m.get("image_pool_grid", 0)
    return gt * gt + 1 if gt and g > gt else g * g + 1


def question_flops(m: dict) -> float:
    """One question through BERT and txt_proj."""
    S, d = m["max_question_len"], m["bert_hidden"]
    f = m["bert_layers"] * (_attn(S, S, d) + _mm(S, d, 4 * d) + _mm(S, 4 * d, d))
    return f + _mm(S, d, m["hidden_dim"])


def fusion_flops(m: dict) -> float:
    """One (image, question) pair through BTIA and the AD head."""
    h, S, ni = m["hidden_dim"], m["max_question_len"], fused_image_tokens(m)
    hid = int(h * m["mlp_ratio"])
    f = m["btia_layers"] * (_attn(ni, S, h) + _attn(S, ni, h) + _mm(ni + S, h, hid) + _mm(ni + S, hid, h))
    V, K = m["answer_vocab_size"], m["num_answer_queries"]
    q = K or V
    # The answer queries' projection is the same for every pair: not counted.
    f += _attn(q, ni + S, h, project_q=False) + _mm(q, h, 2 * h) + _mm(q, 2 * h, h)
    return f + _mm(1, h, V)


def pair_flops(m: dict) -> float:
    """The work one extra question adds to an encoded image."""
    return question_flops(m) + fusion_flops(m)


def request_flops(m: dict, n_questions: int) -> float:
    return vit_flops(m) + n_questions * pair_flops(m)


def train_example_flops(m: dict) -> float:
    """A train example: forward (one image, one question), and a backward
    of twice the forward's products."""
    return 3.0 * request_flops(m, 1)


def dense_bound_s(M: int, K: int, N: int, elem: int = 2) -> float:
    """The least time of a Dense call: max(2MKN at the bf16 peak, bytes of
    x, W, b and y, each once, at the peak bandwidth)."""
    byts = elem * (M * K + K * N + N + M * N)
    return max(_mm(M, K, N) / PEAK_BF16_FLOPS, byts / PEAK_BYTES)


def layernorm_bound_s(rows: int, width: int, in_elem: int, out_elem: int) -> float:
    """A LayerNorm reads x and writes y once, and reads f32 scale and bias."""
    return (rows * width * (in_elem + out_elem) + 8 * width) / PEAK_BYTES
