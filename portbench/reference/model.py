"""Plain float32 reference of the BTIA-AD-Net family that the benchmark's
configurations run: ViT image encoder (bilinear ingest resize, ImageNet
normalization, patch embedding in (p, p, C) order, pre-LN blocks, a final
LayerNorm, optional bilinear pooling of the patch grid to g x g tokens
beside CLS), BERT question encoder (word + position + token-type embeddings,
post-LN blocks, eps 1e-12, mask = ids > 0), the projections to the fusion
width with their LayerNorms, BTIA (per layer two cross-attention directions
from the pre-LN streams, then an FFN on each stream) and the AD head
(answer queries attending over the image and question tokens, an FFN, a
LayerNorm, then per-answer weights or a factorized answer table).

GELU is the tanh form, as the configurations' bf16 policy states. Every
product is ``mm``: plain ``@`` in float32 (run with TF32 off), or a fake
quantized product for the lower-precision control. Parameter names follow
the measured program's state dict, so ``load_state_dict(strict=True)``
checks that both hold the same leaves at the same shapes.

Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# name: (image size, patch, width, depth, heads)
VIT = {"vit_b16": (224, 16, 768, 12, 12), "vit_l336": (336, 14, 1024, 24, 16),
       "vit_test": (96, 8, 64, 2, 4)}
BERT_MAX_LEN, BERT_TYPES = 512, 2

Params = Dict[str, torch.Tensor]
Drop = Optional[Callable[[torch.Tensor], torch.Tensor]]


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 at a per-tensor scale (amax -> 448); the
    gradient passes through unrounded (straight through)."""
    with torch.no_grad():
        s = t.abs().amax().clamp_min(1e-12) / 448.0
        q = (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach() if t.requires_grad else q


def mm_fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands rounded to fp8, the product in
    f32."""
    return _fp8(x) @ _fp8(w)


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ---- the parameters -------------------------------------------------------


def _dense(name: str, din: int, dout: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.kernel", (din, dout), "kernel"), (f"{name}.bias", (dout,), "bias")]


def _ln(name: str, d: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.scale", (d,), "scale"), (f"{name}.bias", (d,), "bias")]


def _attn(prefix: str, d: int) -> list:
    return sum((_dense(f"{prefix}.{p}_proj", d, d) for p in "qkvo"), [])


def param_spec(m: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init kind) of every parameter of the model `m` (a
    config's "model" section), in a fixed order."""
    size, patch, dv, depth, _ = VIT[m["image_encoder"]]
    n_tok = (size // patch) ** 2 + 1
    spec = _dense("image_encoder.patch_embed", patch * patch * 3, dv)
    spec += [("image_encoder.cls_token", (1, 1, dv), "small"), ("image_encoder.pos_embed", (1, n_tok, dv), "small")]
    for i in range(depth):
        b = f"image_encoder.block{i}"
        spec += _ln(f"{b}.ln1", dv) + _attn(f"{b}.attn", dv) + _ln(f"{b}.ln2", dv)
        spec += _dense(f"{b}.mlp.fc1", dv, 4 * dv) + _dense(f"{b}.mlp.fc2", 4 * dv, dv)
    spec += _ln("image_encoder.ln_final", dv)
    dt = m["bert_hidden"]
    q = "question_encoder"
    spec += [(f"{q}.word_embed.embedding", (m["bert_vocab_size"], dt), "embed"),
             (f"{q}.pos_embed.embedding", (BERT_MAX_LEN, dt), "embed"),
             (f"{q}.type_embed.embedding", (BERT_TYPES, dt), "embed")]
    spec += _ln(f"{q}.ln_embed", dt)
    for i in range(m["bert_layers"]):
        b = f"{q}.layer{i}"
        spec += _ln(f"{b}.ln_attn", dt) + _attn(f"{b}.attn", dt)
        spec += _dense(f"{b}.mlp.fc1", dt, 4 * dt) + _dense(f"{b}.mlp.fc2", 4 * dt, dt) + _ln(f"{b}.ln_mlp", dt)
    h = m["hidden_dim"]
    spec += _dense("img_proj", dv, h) + _dense("txt_proj", dt, h) + _ln("img_ln", h) + _ln("txt_ln", h)
    hid = int(h * m["mlp_ratio"])
    for i in range(m["btia_layers"]):
        b = f"btia.layer{i}"
        spec += _ln(f"{b}.ln_img", h) + _ln(f"{b}.ln_txt", h)
        for d in ("i2t", "t2i"):
            spec += sum((_dense(f"{b}.{d}_{p}_proj", h, h) for p in "qkv"), [])
        spec += _dense(f"{b}.i2t_o_proj", h, h) + _dense(f"{b}.t2i_o_proj", h, h)
        spec += _dense(f"{b}.mlp_img.fc1", h, hid) + _dense(f"{b}.mlp_img.fc2", hid, h) + _ln(f"{b}.ln_img2", h)
        spec += _dense(f"{b}.mlp_txt.fc1", h, hid) + _dense(f"{b}.mlp_txt.fc2", hid, h) + _ln(f"{b}.ln_txt2", h)
    V, K = m["answer_vocab_size"], m["num_answer_queries"]
    spec += [("head.answer_queries", (K or V, h), "small")] + _ln("head.ln_kv", h) + _attn("head", h)
    spec += _dense("head.mlp.fc1", h, 2 * h) + _dense("head.mlp.fc2", 2 * h, h)
    spec += _ln("head.ln_mlp", h) + _ln("head.ln_out", h)
    spec += [("head.answer_weights" if K == 0 else "head.answer_table", (V, h), "small"),
             ("head.answer_bias", (V,), "bias")]
    return spec


def make_weights(m: dict, seed: int, device) -> Params:
    """The model's weights from `seed`: one normal draw on `device` for all
    leaves, each slice scaled by its kind: kernels 1/sqrt(fan-in),
    embeddings 1/sqrt(width), learned tokens and answer tables 0.02,
    LayerNorm scales 1 + 0.1 N, biases 0.02 N (not zero, so that every bias
    and LayerNorm path is exercised)."""
    spec = param_spec(m)
    total = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = flat[off : off + n].view(shape)
        off += n
        if kind == "kernel":
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "embed":
            t.mul_(1.0 / math.sqrt(shape[1]))
        elif kind in ("small", "bias"):
            t.mul_(0.02)
        elif kind == "scale":
            t.mul_(0.1).add_(1.0)
        out[name] = t
    return out


# ---- building blocks ------------------------------------------------------


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix, half-pixel centers, no
    antialias."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    out = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        w1 = x - x0
        out[i, min(max(x0, 0), src - 1)] += 1.0 - w1
        out[i, min(max(x0 + 1, 0), src - 1)] += w1
    return out


def layer_norm(x, P: Params, name: str, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * P[f"{name}.scale"] + P[f"{name}.bias"]


def dense(x, P: Params, name: str, mm=mm_f32):
    return mm(x, P[f"{name}.kernel"]) + P[f"{name}.bias"]


def mlp(x, P: Params, name: str, mm=mm_f32, drop: Drop = None):
    h = F.gelu(dense(x, P, f"{name}.fc1", mm), approximate="tanh")
    return dense(h if drop is None else drop(h), P, f"{name}.fc2", mm)


def attention(xq, xkv, mask, P: Params, prefix: str, heads: int, mm=mm_f32):
    """Multi-head attention; `prefix` + "q_proj" etc. name the projections.
    xq (B or 1, Sq, D), xkv (B, Sk, D), mask (B, Sk) True = a real key."""
    q, k, v = (dense(t, P, f"{prefix}{p}_proj", mm) for t, p in ((xq, "q"), (xkv, "k"), (xkv, "v")))
    B = xkv.shape[0]
    hd = q.shape[-1] // heads
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)
    o = o.transpose(1, 2).reshape(B, -1, heads * hd)
    return dense(o, P, f"{prefix}o_proj", mm)


# ---- the model ------------------------------------------------------------


def preprocess(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> resized to (size, size) and normalized, f32."""
    x = images_u8.float()
    dev = x.device
    rh = torch.from_numpy(resize_matrix(x.shape[1], size)).to(dev)
    rw = torch.from_numpy(resize_matrix(x.shape[2], size)).to(dev)
    x = torch.einsum("hH,bHwc->bhwc", rh, x)
    x = torch.einsum("wW,bhWc->bhwc", rw, x)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (x / 255.0 - mean) / std


def encode_image(images_u8, P: Params, m: dict, mm=mm_f32, drop: Drop = None):
    size, p, dv, depth, heads = VIT[m["image_encoder"]]
    x = preprocess(images_u8, size)
    B, g = x.shape[0], size // p
    x = x.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * 3)
    x = dense(x, P, "image_encoder.patch_embed", mm)
    x = torch.cat([P["image_encoder.cls_token"].expand(B, 1, dv), x], 1) + P["image_encoder.pos_embed"]
    for i in range(depth):
        b = f"image_encoder.block{i}"
        h = layer_norm(x, P, f"{b}.ln1", 1e-6)
        x = x + attention(h, h, None, P, f"{b}.attn.", heads, mm)
        x = x + mlp(layer_norm(x, P, f"{b}.ln2", 1e-6), P, f"{b}.mlp", mm, drop)
    x = layer_norm(x, P, "image_encoder.ln_final", 1e-6)
    gt = m.get("image_pool_grid", 0)
    if gt and g > gt:
        r = torch.from_numpy(resize_matrix(g, gt)).to(x.device)
        grid = x[:, 1:].reshape(B, g, g, dv)
        grid = torch.einsum("hH,bHwc->bhwc", r, grid)
        grid = torch.einsum("wW,bhWc->bhwc", r, grid)
        x = torch.cat([x[:, :1], grid.reshape(B, gt * gt, dv)], 1)
    return layer_norm(dense(x, P, "img_proj", mm), P, "img_ln", 1e-6)


def encode_question(ids: torch.Tensor, P: Params, m: dict, mm=mm_f32, drop: Drop = None):
    q, eps = "question_encoder", 1e-12
    mask = ids > 0
    S = ids.shape[1]
    x = (P[f"{q}.word_embed.embedding"][ids] + P[f"{q}.pos_embed.embedding"][:S][None]
         + P[f"{q}.type_embed.embedding"][0])
    x = layer_norm(x, P, f"{q}.ln_embed", eps)
    keep = (lambda t: t) if drop is None else drop
    x = keep(x)
    for i in range(m["bert_layers"]):
        b = f"{q}.layer{i}"
        x = layer_norm(x + keep(attention(x, x, mask, P, f"{b}.attn.", m["bert_heads"], mm)), P, f"{b}.ln_attn", eps)
        x = layer_norm(x + keep(mlp(x, P, f"{b}.mlp", mm)), P, f"{b}.ln_mlp", eps)
    return layer_norm(dense(x, P, "txt_proj", mm), P, "txt_ln", 1e-6), mask


def fuse_and_answer(img, txt, txt_mask, P: Params, m: dict, mm=mm_f32, drop: Drop = None):
    heads = m["num_heads"]
    keep = (lambda t: t) if drop is None else drop
    for i in range(m["btia_layers"]):
        b = f"btia.layer{i}"
        li, lt = layer_norm(img, P, f"{b}.ln_img", 1e-6), layer_norm(txt, P, f"{b}.ln_txt", 1e-6)
        a_i = attention(li, lt, txt_mask, P, f"{b}.i2t_", heads, mm)
        a_t = attention(lt, li, None, P, f"{b}.t2i_", heads, mm)
        img, txt = img + keep(a_i), txt + keep(a_t)
        img = img + keep(mlp(layer_norm(img, P, f"{b}.ln_img2", 1e-6), P, f"{b}.mlp_img", mm))
        txt = txt + keep(mlp(layer_norm(txt, P, f"{b}.ln_txt2", 1e-6), P, f"{b}.mlp_txt", mm))
    tokens = torch.cat([img, txt], 1)
    tmask = torch.cat([torch.ones(img.shape[:2], dtype=torch.bool, device=img.device), txt_mask], 1)
    queries = P["head.answer_queries"]
    kv = layer_norm(tokens, P, "head.ln_kv", 1e-6)
    feats = queries[None] + attention(queries[None], kv, tmask, P, "head.", heads, mm)
    feats = feats + mlp(layer_norm(feats, P, "head.ln_mlp", 1e-6), P, "head.mlp", mm, drop)
    feats = layer_norm(feats, P, "head.ln_out", 1e-6)
    if m["num_answer_queries"] == 0:
        logits = (feats * P["head.answer_weights"][None]).sum(-1)
    else:
        logits = mm(feats.mean(1), P["head.answer_table"].T)
    return logits + P["head.answer_bias"]


def forward(images_u8, ids, P: Params, m: dict, mm=mm_f32, drop: Drop = None):
    """(B, H, W, 3) uint8 images, (B, S) question ids -> (B, vocab) logits."""
    img = encode_image(images_u8, P, m, mm, drop)
    txt, mask = encode_question(ids, P, m, mm, drop)
    return fuse_and_answer(img, txt, mask, P, m, mm, drop)


@torch.no_grad()
def serve_logits(image_u8, ids, P: Params, m: dict, mm=mm_f32, block: int = 64):
    """One image (H, W, 3) uint8 and its questions (Q, S) -> (Q, vocab)
    logits: the image encoded once, the questions in blocks."""
    img = encode_image(image_u8[None], P, m, mm)
    out = []
    for i in range(0, ids.shape[0], block):
        txt, mask = encode_question(ids[i : i + block], P, m, mm)
        out.append(fuse_and_answer(img.expand(txt.shape[0], *img.shape[1:]), txt, mask, P, m, mm))
    return torch.cat(out)
