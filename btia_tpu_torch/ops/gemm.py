"""The port's dense GEMMs: ``gemm_bias`` (bf16, ``csrc/fused_attn.cu``, the
bias and activation in its epilogue) and ``gemm_f32`` (``csrc/gemm_f32.cu``),
their plans and operand rule, and the weights prepared for a kernel once per
version (``prepare_once``). K1/K2's chain, ``models/layers.py::Dense`` and K8
(``ops/quant.py``, whose epilogue applies ``ACTS`` too) use them."""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops._native import H100_SMS

_PREPARED: dict = {}


def prepare_once(sources, tag, make):
    """``make()``, a tuple of tensors computed from `sources` (tensors), once
    per version of the sources: kept under their identity and `tag`, and
    made again when any source is updated in place (an optimizer step,
    ``load_state_dict``: ``_version`` moves) or gets other storage
    (``data_ptr``). An entry goes when a source is freed. The tensors are
    made outside autograd and inference mode, so the cached ones are
    ordinary tensors wherever they are used. Sources that are inference
    tensors keep no version counter and are prepared on every call.
    ``prepare_once.builds`` counts the preparations."""
    if any(t.is_inference() for t in sources):
        return make()
    key = (tag, *map(id, sources))
    stamp = tuple((t._version, t.data_ptr()) for t in sources)
    hit = _PREPARED.get(key)
    if hit is not None and hit[1] == stamp and all(r() is t for r, t in zip(hit[0], sources)):
        return tuple(sources[x] if isinstance(x, int) else x for x in hit[2])
    # inference_mode(False) turns grad mode on: no_grad goes inside it.
    with torch.inference_mode(False), torch.no_grad():
        out = make()
    prepare_once.builds += 1
    # A result that is a source itself (a cast to the dtype it has) is kept
    # by its index, so that the entry holds no source alive.
    held = tuple(next((i for i, t in enumerate(sources) if o is t), o) for o in out)
    drop = lambda _ref, key=key, cache=_PREPARED: cache.pop(key, None)
    _PREPARED[key] = ([weakref.ref(t, drop) for t in sources], stamp, held)
    return out


prepare_once.builds = 0


def prepared_bytes() -> int:
    """Device and host bytes held by ``prepare_once``'s entries."""
    return sum(t.numel() * t.element_size() for _, _, held in _PREPARED.values()
               for t in held if isinstance(t, torch.Tensor))


# The f32 GEMM's block tiles (rows, columns), largest first: the C entry's
# tile argument is the index.
GEMM_F32_TILES = ((128, 128), (128, 64), (64, 64))


def gemm_f32_tile(M: int, N: int) -> int:
    """The f32 GEMM's block tile, an index into ``GEMM_F32_TILES``: the
    largest whose grid gives each of the H100's SMs two blocks, else the
    smallest. At ``vqa_rad_lstm``'s 3136 x 512 -> 512 the 128 x 128 grid has
    100 blocks for 132 SMs and 128 x 64 has 200, so 64 x 64 (392)."""
    for i, (bm, bn) in enumerate(GEMM_F32_TILES):
        if -(-M // bm) * -(-N // bn) >= 2 * H100_SMS:
            return i
    return len(GEMM_F32_TILES) - 1


def gemm_f32(a2, w, b, resid=None, resid_rows=0):
    """a2 @ w + b (+ resid rows, repeating every resid_rows) in f32 on the
    CUDA cores (``csrc/gemm_f32.cu``): the projection GEMM of the fp32
    policy, every product an f32 FFMA. The block tile is
    ``gemm_f32_tile``'s; W's loads and the epilogue take 16-byte vectors
    where N % 4 == 0 and the pointers are 16-byte aligned. Counts its
    launches in ``.launches``."""
    M, K = a2.shape
    N = w.shape[1]
    a2, w, b = a2.contiguous(), w.contiguous(), b.float().contiguous()
    _native.require(a2, "f32 GEMM input", torch.float32)
    _native.require(w, "f32 GEMM weight", torch.float32)
    if resid is not None:
        resid = resid.contiguous()
        _native.require(resid, "f32 GEMM residual", torch.float32)
    out = torch.empty((M, N), dtype=torch.float32, device=a2.device)
    vec = N % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in (w, b, resid, out))
    _native.check(
        _native.lib().btia_gemm_f32(
            a2.data_ptr(), w.data_ptr(), b.data_ptr(), None if resid is None else resid.data_ptr(),
            max(resid_rows, 1), out.data_ptr(), M, N, K, gemm_f32_tile(M, N), int(vec), _native.stream(a2),
        ),
        "btia_gemm_f32",
    )
    gemm_f32.launches += 1
    return out


gemm_f32.launches = 0


# The bf16 projection GEMM's output tiles (rows, columns): the C entry's
# tile argument is the index.
GEMM_TILES = ((128, 256), (128, 128))
# What a 128 x 256 tile costs against two 128 x 128 tiles (one A read a
# column of tiles fewer, wgmma at N = 256): the tile choice's weight.
GEMM_WIDE_TILE_COST = 0.9


@functools.lru_cache(maxsize=256)
def gemm_plan(M: int, N: int) -> tuple:
    """(tile, grid) of the bf16 projection GEMM (``gemm_bias_ws_kernel``):
    the tile an index into ``GEMM_TILES``, the grid one persistent block an
    H100 SM up to one a tile; block i takes tiles i, i + grid, ... (N tiles
    fastest). 128 x 256 where N is a multiple of 256 and the rounds of
    tiles a block walks, weighted by ``GEMM_WIDE_TILE_COST``, cost no more
    than 128 x 128's: at every serve site (text 65,536 rows: 12 rounds
    against 24); 128 x 128 where the wide tile would leave SMs idle, as at
    the train sites (12,608 rows: 3 rounds of 297 wide tiles against 5 of
    594). The same at the serve step's Mlp products (``Dense``'s, with the
    GELU in the epilogue at fc1): the wide tile everywhere but ViT-L's fc2
    (9,232 rows to 1,024 columns), where both tiles take the same time."""
    def tiles(i):
        bm, bn = GEMM_TILES[i]
        return -(-M // bm) * -(-N // bn)

    rounds = lambda i: -(-tiles(i) // H100_SMS)
    tile = 0 if N % 256 == 0 and 2 * GEMM_WIDE_TILE_COST * rounds(0) <= rounds(1) else 1
    return tile, min(tiles(tile), H100_SMS)


# The activations the epilogues of the bf16 projection GEMM and of K8
# (ops/quant.py) apply after the bias: the C entries' act argument is the
# index.
ACTS = (None, "gelu_tanh")


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The activation named `act` (None or ``"gelu_tanh"``), in y's dtype."""
    if act is None:
        return y
    if act == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def gemm_takes(dtype: torch.dtype, K: int, N: int) -> bool:
    """Whether the bf16 projection GEMM takes (M, K) x (K, N) operands of `dtype`
    on the card: bf16, K and N multiples of 8 (TMA's rows are 16-byte ones)."""
    return dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0


def gemm_bias(a2, w, b, resid=None, resid_rows=0, act=None):
    """bf16(act(a2 @ w + b)) (+ resid rows, repeating every resid_rows), on
    the projection GEMM (``gemm_bias_ws_kernel``, tile and grid by
    ``gemm_plan``): TMA reads a2 (M, K) and w (K, N) as they lie and stores
    the output, at 16-byte aligned addresses; act (``ACTS``: None or
    ``"gelu_tanh"``, Dense's under an Mlp's fc1) is taken in f32 before the
    one bf16 rounding, and never with a residual. f32 operands take
    ``gemm_f32``, which has no activation; any other operands that
    ``gemm_takes`` refuses raise."""
    if act not in ACTS or (act is not None and (resid is not None or a2.dtype == torch.float32)):
        raise ValueError(f"bias GEMM kernel takes act in {ACTS} on bf16 operands without a residual, "
                         f"got {act!r} on {a2.dtype}{' with a residual' if resid is not None else ''}")
    if a2.dtype == torch.float32:
        return gemm_f32(a2, w, b, resid, resid_rows)
    M, K = a2.shape
    N = w.shape[1]
    if not gemm_takes(a2.dtype, K, N):
        raise ValueError(f"bias GEMM kernel takes bf16 or f32 operands, K, N multiples of 8 in bf16; "
                         f"got {a2.dtype}, K, N = {K}, {N}")
    a2 = _native.aligned(a2)
    w = _native.aligned(w.to(a2.dtype))
    b = b.float().contiguous()
    out = torch.empty((M, N), dtype=a2.dtype, device=a2.device)
    _native.require(a2, "bias GEMM input")
    if resid is not None:
        resid = _native.aligned(resid)
        _native.require(resid, "bias GEMM residual")
    _native.check(
        _native.lib().btia_gemm_bias(
            a2.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if resid is None else resid.data_ptr(), max(resid_rows, 1),
            out.data_ptr(), M, N, K, ACTS.index(act), *gemm_plan(M, N), _native.stream(a2),
        ),
        "btia_gemm_bias",
    )
    return out
