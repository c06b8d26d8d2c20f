"""The yardstick's operation and byte counts against hand counts."""

import dataclasses

import pytest

from btia_tpu_torch.configs import get_config
from portbench import flops as F


def test_dense_bound_is_compute_bound_at_a_large_product():
    M, K, N = 2048, 768, 3072
    assert F.dense_bound_s(M, K, N) == pytest.approx(2 * 2048 * 768 * 3072 / 989e12)


def test_dense_bound_is_byte_bound_at_one_row():
    # x 768, W 768*768, b 768, y 768 bf16 elements
    assert F.dense_bound_s(1, 768, 768) == pytest.approx(2 * (768 + 768 * 768 + 768 + 768) / 3.35e12)


@pytest.mark.parametrize("rows,width,e_in,e_out", [(65536, 768, 2, 2), (9232, 1024, 4, 2)])
def test_layernorm_bound(rows, width, e_in, e_out):
    assert F.layernorm_bound_s(rows, width, e_in, e_out) == pytest.approx(
        (rows * width * (e_in + e_out) + 8 * width) / 3.35e12)


def tiny_model():
    return dataclasses.asdict(get_config("streaming_vitl", **{
        "model.image_encoder": "vit_test", "model.bert_layers": 2, "model.bert_hidden": 128,
        "model.bert_heads": 2, "model.hidden_dim": 128, "model.num_heads": 2, "model.btia_layers": 1,
        "model.answer_vocab_size": 64, "model.num_answer_queries": 8}).model)


def test_vit_flops_by_hand_at_the_test_encoder():
    m = tiny_model()
    n, d, h = 145, 64, 128  # 12 x 12 patches + CLS, pooled to 7 x 7 + CLS = 50
    patch = 2 * 144 * 192 * d
    attn = 2 * n * d * 2 * d + 2 * 2 * n * d * d + 2 * 2 * n * d * n
    ffn = 2 * 2 * n * d * 4 * d
    assert F.vit_flops(m) == 2 * (attn + ffn) + patch + 2 * 50 * d * h


def test_pair_flops_by_hand_at_the_test_sizes():
    m = tiny_model()
    S, dt, h, ni, K, V = 32, 128, 128, 50, 8, 64
    bert = 2 * (2 * S * dt * 2 * dt + 2 * 2 * S * dt * dt + 2 * 2 * S * dt * S + 2 * 2 * S * dt * 4 * dt)
    bert += 2 * S * dt * h
    btia = (2 * S * h * 2 * h + 2 * 2 * ni * h * h + 2 * 2 * ni * h * S) \
        + (2 * ni * h * 2 * h + 2 * 2 * S * h * h + 2 * 2 * S * h * ni) + 2 * 2 * (ni + S) * h * 4 * h
    head = 2 * (ni + S) * h * 2 * h + 2 * K * h * h + 2 * 2 * K * h * (ni + S) + 2 * 2 * K * h * 2 * h + 2 * h * V
    assert F.pair_flops(m) == bert + btia + head


def test_the_serve_step_is_28_tflop():
    m = dataclasses.asdict(get_config("streaming_vitl").model)
    assert 16 * F.request_flops(m, 128) == pytest.approx(28.2e12, rel=0.01)
