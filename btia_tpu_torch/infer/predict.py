"""Inference API (port of ``btia_tpu/infer/predict.py``):

    predict(image, question) -> answer logits

plus the many-questions-per-image form that encodes the image once and fans
the questions out. Question counts are padded up to a bucket with all-PAD
rows (their logits are sliced off), as in the reference.

Images are a path or bytes (JPEG, PNG or DICOM, decoded and resized on the
host to the ingest size ``max(256, image_size)``) or a uint8 array of any
size, (H, W, 3) or (H, W). The fan-out forwards (``_fanout_forward`` and
its dedup and packed-pair forms) return callables that launch the work on
the model's device and return device tensors without waiting for it, so a
server can launch one batch while the card runs the one before. PyTorch runs
eagerly: there is no compiled-program cache.

With ``mesh`` (a ``parallel.Mesh``; every rank of it builds the same
Predictor and drives the same calls) the weights take the TP layout of
``parallel/sharding.py`` and every forward runs inside ``fused_mesh``: a
batch-shaped input whose leading dim divides the data axis is split over
it, any other stays whole on every rank (so a 1-image ``predict`` works on
any mesh), and every rank gets the whole result (``infer/sharded.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from btia_tpu_torch.configs.config import Config
from btia_tpu_torch.core.device import resolve_device
from btia_tpu_torch.data.image import load_ingest_image, resize_uint8
from btia_tpu_torch.data.vocab import AnswerVocab, WordVocab
from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
from btia_tpu_torch.models.model import BTIAADNet, build_model
from btia_tpu_torch.ops.answers import argmax_real, real_limit

ImageLike = Union[str, Path, bytes, np.ndarray]


def _bucket(n: int, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


class Predictor:
    def __init__(
        self,
        model: BTIAADNet,
        state: Optional[Mapping[str, torch.Tensor]],
        text_encoder,
        answer_vocab: AnswerVocab,
        cfg: Config,
        device="cuda",
        mesh=None,
    ):
        """`state`: a full state dict for `model` (loaded strictly), or None
        to serve the weights the model already holds. `mesh`: serve through
        a DP x TP mesh (see the module docstring)."""
        self.device = resolve_device(device)
        if state is not None:
            model.load_state_dict(state, strict=True)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            from btia_tpu_torch.infer.sharded import shard_serving_params

            shard_serving_params(self.model, mesh)
        self.text_encoder = text_encoder
        self.answer_vocab = answer_vocab
        self.cfg = cfg
        self.ingest_size = max(256, cfg.model.image_size)

    # -- plumbing ---------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, workdir: str | Path, best: bool = True, device="cuda",
                        mesh=None) -> "Predictor":
        """Load config + vocabs + best/latest weights from a Trainer workdir
        (a checkpoint holds the whole state, whatever mesh wrote it), served
        through `mesh` if given."""
        from btia_tpu_torch.train.checkpoint import Checkpointer
        from btia_tpu_torch.train.steps import create_state

        workdir = Path(workdir)
        ckpt = Checkpointer(workdir / "checkpoints")
        cfg = ckpt.load_config()
        model = build_model(cfg.model, device=device)
        ckpt.restore(create_state(model, cfg, steps_per_epoch=1), best=best)

        vocab_dir = workdir / "vocabs"
        answer_vocab = AnswerVocab.load(vocab_dir / "answer_vocab.json")
        if (vocab_dir / "question_vocab.json").exists():
            text_encoder = WordVocab.load(vocab_dir / "question_vocab.json")
        else:
            text_encoder = WordPieceTokenizer.from_vocab_file(vocab_dir / "wordpiece_vocab.txt")
        return cls(model, None, text_encoder, answer_vocab, cfg, device=device, mesh=mesh)

    def _prep_image(self, image: ImageLike) -> np.ndarray:
        """Host side only (decode threads call it): uint8 (S, S, 3) at the
        ingest size."""
        if isinstance(image, np.ndarray):
            if image.ndim == 2:
                image = np.repeat(image[:, :, None], 3, axis=2)
            if image.shape[:2] != (self.ingest_size, self.ingest_size):
                image = resize_uint8(image.astype(np.uint8), self.ingest_size)
            return image.astype(np.uint8)
        return load_ingest_image(image, self.ingest_size)

    def _tokenize(self, questions: Sequence[str]) -> np.ndarray:
        L = self.cfg.model.max_question_len
        return np.asarray([self.text_encoder.encode(q, L) for q in questions], np.int64)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))  # PIL's arrays are read-only
        if t.dtype == torch.int32:
            t = t.long()
        if self.device.type == "cuda":  # a pinned copy does not stall the host
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _forward(self, method: str) -> Callable[..., torch.Tensor]:
        """images (B, S, S, 3) uint8 and the method's index arrays (numpy)
        -> its logits, a device tensor, launched and not waited for."""
        answer = getattr(self.model, method)

        @torch.inference_mode()
        def fwd(images: np.ndarray, *data: np.ndarray) -> torch.Tensor:
            if self.mesh is not None:
                from btia_tpu_torch.infer.sharded import mesh_forward

                return mesh_forward(self.model, self.mesh, method, self._to_device(images),
                                    [self._to_device(d) for d in data])
            img_tokens = self.model.encode_image(self._to_device(images))
            return answer(img_tokens, *(self._to_device(d) for d in data))

        return fwd

    def _fanout_forward(self, B: int, Q: int):
        """images (B, S, S, 3), qids (B, Q, L) -> (B, Q, vocab)."""
        return self._forward("answer_questions")

    def _pairs_forward(self, B: int, U: int, P: int):
        """Packed pair-list fan-out: images (B, ...), unique ids (U, L),
        pair_img (P,), pair_q (P,) -> (P, vocab) (see answer_pairs)."""
        return self._forward("answer_pairs")

    def _fanout_forward_indexed(self, B: int, Q: int, U: int):
        """Deduplicated fan-out: images (B, ...), unique ids (U, L), qmap
        (B, Q) -> (B, Q, vocab); the same logits as the plain fan-out."""
        return self._forward("answer_questions_indexed")

    # -- public API --------------------------------------------------------

    def predict(self, image: ImageLike, question: str) -> np.ndarray:
        """(image, question) -> answer logits, shape (vocab,)."""
        return self.predict_batch(image, [question])[0]

    def predict_batch(self, image: ImageLike, questions: Sequence[str]) -> np.ndarray:
        """Many questions, ONE image encode -> (len(questions), vocab)."""
        n = len(questions)
        Q = _bucket(n)
        qids = np.zeros((1, Q, self.cfg.model.max_question_len), np.int64)
        qids[0, :n] = self._tokenize(questions)
        images = self._prep_image(image)[None]
        logits = self._fanout_forward(1, Q)(images, qids)
        return logits[0, :n].cpu().numpy()

    def predict_answers(self, image: ImageLike, questions: Sequence[str]) -> List[str]:
        """Decoded answer strings for many questions, ONE image encode."""
        logits = self.predict_batch(image, questions)
        limit = real_limit(len(self.answer_vocab), logits.shape[-1])
        return [self.answer_vocab.decode(int(i)) for i in argmax_real(logits, limit)]

    def predict_answer(self, image: ImageLike, question: str) -> str:
        logits = self.predict(image, question)
        limit = real_limit(len(self.answer_vocab), logits.shape[-1])
        return self.answer_vocab.decode(int(argmax_real(logits, limit)))


def predict(image: ImageLike, question: str, workdir: str | Path, best: bool = True,
            device="cuda") -> np.ndarray:
    """One-shot convenience wrapper over Predictor."""
    return Predictor.from_checkpoint(workdir, best=best, device=device).predict(image, question)
