"""Sharded serving over a (data, model) mesh (the port of
``btia_tpu/infer/sharded.py``).

  * the image batch and its question fan-out split over 'data' (DP): each
    rank of a data index serves its own rows;
  * ViT-L / BERT / BTIA / AD-head weights are split over 'model' (TP) by the
    rules of ``parallel/sharding.py``: each rank holds its shards, and the
    sites and MLPs sum their partial outputs over the model group once a
    block;
  * every rank returns the whole result, gathered over the data group, as a
    global JAX array reads whole on every process.

The reference's serve functions take the variables as an argument; the
port's model holds its (sharded) weights, so ``serve`` takes the batch
alone. Every rank of the mesh calls it with the same global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from btia_tpu_torch.models.model import BTIAADNet
from btia_tpu_torch.ops.fused_attn import fused_mesh
from btia_tpu_torch.parallel.collectives import gather_rows
from btia_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from btia_tpu_torch.parallel.sharding import Spec, shard_batch, shard_params


def shard_serving_params(model: BTIAADNet, mesh: Mesh) -> Dict[str, Spec]:
    """Slice the model's TP parameters to this rank's shards, in place
    (nothing moves at model=1); BatchNorm's statistics stay whole."""
    return shard_params(model, mesh)


def _topk_real_answers(logits, k: int, vocab_limit: Optional[int]):
    """top_k over REAL answers (the ops/answers.py rule: no <unk>, no
    padding past the built vocab)."""
    from btia_tpu_torch.ops.answers import topk_real

    return topk_real(logits, k, vocab_limit)


def _require_vocab_limit(topk: int, vocab_limit: Optional[int]) -> None:
    # The static head is padded past the built vocab; top-k without a
    # vocab_limit could surface padding slots as "answers".
    if topk and not vocab_limit:
        raise ValueError(
            "topk>0 requires vocab_limit=len(answer_vocab) so static-head "
            "padding slots are excluded from the returned answer ids"
        )


class _Rows:
    """The reference's ``_constrain`` on one mesh: a batch-shaped input whose
    leading dim divides the data axis is split over it (this rank's rows),
    any other stays whole on every rank; ``whole`` gathers a result computed
    on split rows."""

    def __init__(self, mesh: Mesh, strict: bool = False):
        self.mesh = mesh
        self.dp = mesh.shape[DATA_AXIS]
        self.strict = strict

    def take(self, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        if self.dp == 1:
            return x, False
        if x.shape[0] % self.dp:
            if self.strict:
                raise ValueError(f"batch dim {x.shape[0]} does not divide over data={self.dp}")
            return x, False
        return shard_batch(x, self.mesh), True

    def whole(self, y, split: bool):
        if not split:
            return y
        if isinstance(y, (tuple, list)):
            return tuple(gather_rows(t, self.mesh) for t in y)
        return gather_rows(y, self.mesh)


def mesh_forward(model: BTIAADNet, mesh: Mesh, method: str, images: torch.Tensor,
                 data: Sequence[torch.Tensor], topk: int = 0, vocab_limit: Optional[int] = None,
                 strict: bool = False):
    """One serving forward (`method`: ``answer_questions``,
    ``answer_questions_indexed`` or ``answer_pairs``) of a global batch over
    the mesh; every rank returns the whole result. The image rows, the
    unique-question rows and the pair rows split over 'data' where they
    divide it (``strict``: they must); features that a later stage indexes
    across rows (the unique questions' features, and the image tokens of
    the pair form) are gathered over the data group first."""
    rows = _Rows(mesh, strict)
    imgs, img_split = rows.take(images)
    with fused_mesh(mesh):
        img_tokens = model.encode_image(imgs)
        if method == "answer_questions":
            (qids,) = data
            logits = model.answer_questions(img_tokens, rows.take(qids)[0] if img_split else qids)
            out_split = img_split
        else:
            uniq, u_split = rows.take(data[0])
            txt_u, mask_u = model.encode_question(uniq)
            txt_u, mask_u = rows.whole(txt_u, u_split), rows.whole(mask_u, u_split)
            if method == "answer_questions_indexed":
                qmap = rows.take(data[1])[0] if img_split else data[1]
                B, Q = qmap.shape
                flat = qmap.reshape(B * Q)
                logits = model.fuse_and_answer(
                    model._replicate(img_tokens, Q), txt_u[flat], mask_u[flat]).reshape(B, Q, -1)
                out_split = img_split
            elif method == "answer_pairs":
                img_tokens = rows.whole(img_tokens, img_split)
                pair_img, out_split = rows.take(data[1])
                pair_q = rows.take(data[2])[0] if out_split else data[2]
                logits = model.fuse_and_answer(img_tokens[pair_img], txt_u[pair_q], mask_u[pair_q])
            else:
                raise ValueError(f"no serving method {method!r}")
        out = _topk_real_answers(logits, topk, vocab_limit) if topk else logits
    return rows.whole(out, out_split)


def make_sharded_serve_fn(
    model: BTIAADNet,
    mesh: Mesh,
    topk: int = 0,
    vocab_limit: Optional[int] = None,
) -> Callable:
    """Returns serve(images (B, H, W, 3) uint8, qids (B, Q, L)) over the
    mesh, for a model whose weights ``shard_serving_params`` placed. B must
    divide the 'data' axis. topk > 0 -> (vals, idxs) over real answers only;
    vocab_limit = len(answer_vocab) is REQUIRED then, so the static head's
    padding slots are masked too."""
    _require_vocab_limit(topk, vocab_limit)

    @torch.inference_mode()
    def serve(images, qids):
        return mesh_forward(model, mesh, "answer_questions", images, (qids,), topk, vocab_limit, strict=True)

    return serve


def make_sharded_serve_indexed_fn(
    model: BTIAADNet,
    mesh: Mesh,
    topk: int = 0,
    vocab_limit: Optional[int] = None,
) -> Callable:
    """The unique-question-dedup form of ``make_sharded_serve_fn``:
    serve(images (B, ...), unique_ids (U, S), qmap (B, Q)).

    The unique-question rows split over 'data' (each rank encodes U/dp of
    the question tower), then their features are gathered over the data
    group for the per-pair gather (``sharded.py:89-96``). B and U must
    divide the data axis. topk > 0 requires vocab_limit."""
    _require_vocab_limit(topk, vocab_limit)

    @torch.inference_mode()
    def serve(images, unique_ids, qmap):
        return mesh_forward(model, mesh, "answer_questions_indexed", images, (unique_ids, qmap),
                            topk, vocab_limit, strict=True)

    return serve
