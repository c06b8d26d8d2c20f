"""BTIAADNet — model assembly and the serving API (port of
``btia_tpu/models/model.py``).

Every registered configuration builds: {ResNet | ViT-B/16 | ViT-L/336} x
{LSTM | BERT} x BTIA fusion x {AD head | mlp head}. On the card, under the
bf16 policy, ``streaming_vitl`` is served through ``Predictor`` (the
serving entry points) and ``vqa_med_full`` trains and evaluates through
``train.trainer.Trainer`` (``forward`` with ``train`` on and off);
``chip_smoke.py`` drives both, ``pathvqa_vit`` through one train step and
an eval forward, and ``vqa_rad_lstm`` (ResNet-50, bi-LSTM, mlp head) and
``slake_bert`` (ResNet-50, BERT, mlp head) through serving, ``Predictor``,
training and evaluation; under the fp32 policy (``tiny_test``'s, or
``model.mixed_precision=False``) the fused sites run on the f32 kernels. With ``int8_ffn`` under the
bf16 policy, every Mlp of a deterministic forward runs its two products
through K8 (``ops/quant.py``); a train forward stays on the fp path, as in
the reference (``model.py:36-43``). ``model.remat`` rematerialises each ViT
block and each BTIA layer in the backward pass, where the reference's
``nn.remat`` does; the ResNet and BERT are not.

``encode_image`` / ``answer_questions`` split the forward so that the image
encoder runs once per image and only the question tower, fusion and head fan
out per question. Every entry point takes ``train`` (dropout on and, with a
ResNet, BatchNorm on batch statistics with its running averages updated, as
the reference's ``train`` flag) and, when the config's dropout is above 0,
the ``torch.Generator`` the dropout masks are drawn from.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from btia_tpu_torch.configs.config import ModelConfig
from btia_tpu_torch.core.device import resolve_device
from btia_tpu_torch.core.dtypes import DTypePolicy, default_policy
from btia_tpu_torch.models.bert import BertQuestionEncoder, BertSpec
from btia_tpu_torch.models.btia import BTIA
from btia_tpu_torch.models.heads import ADHead, SimpleClassifier
from btia_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from btia_tpu_torch.models.lstm import LSTMQuestionEncoder
from btia_tpu_torch.models.resnet import build_resnet
from btia_tpu_torch.models.vit import VIT_SPECS, ViT
from btia_tpu_torch.ops.ingest import preprocess_images, resize_matrix


class BTIAADNet(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        policy = default_policy(cfg.mixed_precision)
        if cfg.int8_ffn and cfg.mixed_precision:  # serving-only int8 FFNs (K8)
            policy = dataclasses.replace(policy, int8=True)
        self.policy: DTypePolicy = policy
        if cfg.image_encoder in VIT_SPECS:
            self.image_encoder = ViT(VIT_SPECS[cfg.image_encoder], policy, device, cfg.remat)
        else:
            self.image_encoder = build_resnet(cfg.image_encoder, policy, device)
        if cfg.question_encoder == "lstm":
            self.question_encoder = LSTMQuestionEncoder(
                cfg.question_vocab_size, cfg.word_embed_dim, cfg.lstm_hidden,
                cfg.lstm_bidirectional, policy, device,
            )
            txt_dim = self.question_encoder.out_dim
        else:
            self.question_encoder = BertQuestionEncoder(
                BertSpec(
                    vocab_size=cfg.bert_vocab_size,
                    dim=cfg.bert_hidden,
                    depth=cfg.bert_layers,
                    num_heads=cfg.bert_heads,
                    mlp_dim=4 * cfg.bert_hidden,
                ),
                policy,
                device,
            )
            txt_dim = cfg.bert_hidden
        self.img_proj = Dense(cfg.image_dim, cfg.hidden_dim, policy, device)
        self.txt_proj = Dense(txt_dim, cfg.hidden_dim, policy, device)
        self.img_ln = LayerNorm(cfg.hidden_dim, policy, device=device)
        self.txt_ln = LayerNorm(cfg.hidden_dim, policy, device=device)
        self.btia = BTIA(cfg.hidden_dim, cfg.num_heads, cfg.btia_layers, cfg.mlp_ratio, policy, device,
                         cfg.remat)
        if cfg.head == "ad":
            self.head = ADHead(
                cfg.hidden_dim, cfg.num_heads, cfg.answer_vocab_size,
                num_queries=cfg.num_answer_queries, policy=policy, device=device,
            )
        else:
            self.head = SimpleClassifier(cfg.hidden_dim, cfg.answer_vocab_size, policy=policy, device=device)

    # ---- staged API (encode once, fan out questions) ---------------------

    def _pool_image_tokens(self, feats: torch.Tensor) -> torch.Tensor:
        """Bilinear-downsample the patch or grid tokens to a (g, g) grid via
        two matrix products, keeping a ViT's CLS token (a ResNet has none;
        ``model.py:114-136``)."""
        gt = self.cfg.image_pool_grid
        if not gt:
            return feats
        has_cls = self.cfg.image_encoder in VIT_SPECS
        cls, grid = (feats[:, :1], feats[:, 1:]) if has_cls else (None, feats)
        B, N, D = grid.shape
        g = int(round(N**0.5))
        if g <= gt:
            return feats
        m = resize_matrix(g, gt, grid.device, grid.dtype)
        x = grid.reshape(B, g, g, D)
        x = torch.einsum("hH,bHwc->bhwc", m, x)
        x = torch.einsum("wW,bhWc->bhwc", m, x)
        x = x.reshape(B, gt * gt, D)
        return torch.cat([cls, x], dim=1) if has_cls else x

    def _dropout(self, train: bool, generator: Optional[torch.Generator]) -> Optional[Dropout]:
        if not train or self.cfg.dropout == 0.0:
            return None
        if generator is None:
            raise ValueError("train=True with dropout > 0 needs a torch.Generator")
        return Dropout(self.cfg.dropout, generator)

    def encode_image(self, images: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images: uint8/float (B, H, W, 3), any size -> (B, N_img, hidden)."""
        s = self.cfg.image_size
        x = preprocess_images(images, (s, s), out_dtype=self.policy.compute_dtype)
        feats = self.image_encoder(x, self._dropout(train, generator), train)
        return self.img_ln(self.img_proj(self._pool_image_tokens(feats)))

    def encode_question(
        self, question_ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, mask = self.question_encoder(question_ids, mask, self._dropout(train, generator), train)
        return self.txt_ln(self.txt_proj(feats)), mask

    def fuse_and_answer(self, img_tokens, txt_tokens, txt_mask, train: bool = False,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = self._dropout(train, generator)
        img_f, txt_f = self.btia(img_tokens, txt_tokens, txt_mask, drop, train)
        if self.cfg.head != "ad":
            return self.head(img_f, txt_f, txt_mask, drop, train)
        tokens = torch.cat([img_f, txt_f], dim=1)
        img_valid = torch.ones(img_f.shape[:2], dtype=torch.bool, device=img_f.device)
        token_mask = torch.cat([img_valid, txt_mask], dim=1)
        return self.head(tokens, token_mask, drop, train)

    @staticmethod
    def _replicate(img_tokens: torch.Tensor, Q: int) -> torch.Tensor:
        B, n, d = img_tokens.shape
        return img_tokens[:, None].expand(B, Q, n, d).reshape(B * Q, n, d)

    def answer_questions(
        self,
        img_tokens: torch.Tensor,  # (B, N_img, hidden) from encode_image
        question_ids: torch.Tensor,  # (B, Q, S)
        q_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Fan out Q questions per encoded image -> (B, Q, vocab)."""
        B, Q, S = question_ids.shape
        flat_mask = q_mask.reshape(B * Q, S) if q_mask is not None else None
        txt, txt_mask = self.encode_question(
            question_ids.reshape(B * Q, S), flat_mask, train, generator)
        logits = self.fuse_and_answer(
            self._replicate(img_tokens, Q), txt, txt_mask, train, generator)
        return logits.reshape(B, Q, -1)

    def answer_questions_indexed(
        self,
        img_tokens: torch.Tensor,  # (B, N_img, hidden)
        unique_ids: torch.Tensor,  # (U, S) deduplicated question rows
        qmap: torch.Tensor,  # (B, Q) indices into the U axis
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``answer_questions`` with the question tower run once per unique
        question; per-pair features are gathered -> (B, Q, vocab)."""
        B, Q = qmap.shape
        txt_u, mask_u = self.encode_question(unique_ids, None, train, generator)
        flat = qmap.reshape(B * Q)
        logits = self.fuse_and_answer(
            self._replicate(img_tokens, Q), txt_u[flat], mask_u[flat], train, generator
        )
        return logits.reshape(B, Q, -1)

    def answer_pairs(
        self,
        img_tokens: torch.Tensor,  # (B, N_img, hidden)
        unique_ids: torch.Tensor,  # (U, S)
        pair_img: torch.Tensor,  # (P,) image index per pair
        pair_q: torch.Tensor,  # (P,) unique-question index per pair
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Packed pair-list fan-out -> (P, vocab)."""
        txt_u, mask_u = self.encode_question(unique_ids, None, train, generator)
        return self.fuse_and_answer(
            img_tokens[pair_img], txt_u[pair_q], mask_u[pair_q], train, generator)

    def forward(self, images, question_ids, q_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(image, question) -> answer logits: images (B, H, W, 3), question
        ids (B, S) -> (B, vocab)."""
        img = self.encode_image(images, train, generator)
        txt, txt_mask = self.encode_question(question_ids, q_mask, train, generator)
        return self.fuse_and_answer(img, txt, txt_mask, train, generator)


_SMALL_INIT = ("cls_token", "pos_embed", "answer_queries", "answer_table", "answer_weights")


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: Dense, conv and recurrent kernels
    lecun-normal (a conv kernel, (out, in, kh, kw), over its fan-in in * kh
    * kw), biases zero, LayerNorm and BatchNorm scales one, embeddings
    normal(1/sqrt(dim)), learned tokens and answer tables normal(0.02).
    BatchNorm's running statistics (buffers) keep their 0 and 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "answer_bias", "hh_bias"):
            p.zero_()
        elif leaf in _SMALL_INIT:
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "kernel" and p.ndim == 4:
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)
        elif leaf in ("kernel", "hh_kernel"):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=generator)
        elif leaf == "embedding":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        else:
            raise KeyError(f"no initializer for parameter {name}")


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> BTIAADNet:
    """A model with random weights made from `seed`, in eval mode, on
    `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    model = BTIAADNet(cfg, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
