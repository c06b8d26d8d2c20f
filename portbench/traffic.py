"""The one traffic generator. A mix is a data file, ``traffic/<mix>.json``;
this module reads its parameters and makes every input of a run from
``--seed``: the question pool, the WordPiece vocabulary file, the images,
the question counts and arrival times of the serve mixes, and the VQA-Med
corpus of the train mixes. The same seed gives the same inputs.

Counts and gaps are stratified: a run of n requests takes the n quantiles
of the stated distribution, in an order drawn from the seed, so every seed
serves the same work and only its order changes.

What a serve mix may state, all of it data:

- ``loop``: ``closed`` (a standing backlog) or ``open`` (arrivals at
  ``rate_rps`` on average, Poisson, optionally shaped by ``phases``:
  [[seconds, relative rate], ...] repeated over the window, e.g. on/off
  bursts);
- ``questions.per_request``: a count distribution, ``fixed``, ``power``
  or ``choice`` (stated values and weights);
- ``questions.pick``: how a request's questions are drawn from the pool,
  ``uniform`` (the default) or ``zipf`` with exponent ``s`` (repeats, as
  a template-heavy tool sends them);
- ``images.format``: ``uint8`` arrays at ``images.size`` (the default) or
  ``jpeg`` bytes at ``images.quality``, which the server decodes.
"""

from __future__ import annotations

import fcntl
import hashlib
import io
import itertools
import json
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

# VQA-RAD-style question grammar (radiology questions about one image).
ORGANS = (
    "lung", "lungs", "heart", "liver", "spleen", "kidney", "kidneys", "brain", "aorta", "bowel",
    "colon", "stomach", "pancreas", "gallbladder", "bladder", "trachea", "diaphragm", "esophagus",
    "ventricles", "mediastinum", "pleura", "spine", "ribs", "femur", "pelvis", "thyroid",
    "prostate", "uterus", "appendix", "duodenum", "cerebellum", "sinuses",
)
FINDINGS = (
    "mass", "lesion", "nodule", "effusion", "pneumothorax", "fracture", "hemorrhage", "infarct",
    "edema", "cyst", "abscess", "calcification", "consolidation", "atelectasis", "cardiomegaly",
    "hydronephrosis", "pneumoperitoneum", "obstruction", "aneurysm", "thrombus", "stone",
    "herniation", "metastasis", "opacity", "enhancement", "dilation", "stenosis", "infiltrate",
    "fluid", "air", "shift", "tumor", "granuloma", "emphysema", "fibrosis", "contusion",
)
MODALITIES = ("ct", "mri", "x-ray", "ultrasound", "pet", "angiogram", "t1", "t2", "flair", "dwi")
PLANES = ("axial", "coronal", "sagittal", "transverse", "oblique", "lateral", "frontal")
SIDES = ("left", "right", "upper", "lower", "anterior", "posterior", "medial", "distal")
ADJ = ("abnormal", "enlarged", "normal", "dilated", "thickened", "hyperdense", "hypodense",
       "hyperintense", "hypointense", "irregular", "symmetric", "calcified")
TEMPLATES = (
    "is there {f} in the {o}?", "is the {o} {a}?", "is there evidence of {f}?",
    "where is the {f} located?", "which side is the {f} on?", "what is {a} in the {o}?",
    "is the {f} in the {s} {o}?", "is this a {m} image?", "what plane is this {m} taken in?",
    "is the {o} {a} on this {m}?", "does the {o} show {f}?", "how large is the {f} in the {o}?",
    "is there {f} seen on this {p} {m}?", "what is the {f} compressing in the {o}?",
    "is the {s} {o} {a} compared to the other side?", "was contrast given for this {m} of the {o}?",
)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def all_questions() -> List[str]:
    """Every question the grammar makes, sorted (a fixed universe)."""
    slots = {"o": ORGANS, "f": FINDINGS, "a": ADJ[:6], "s": SIDES[:4], "m": MODALITIES[:6], "p": PLANES[:3]}
    out = set()
    for t in TEMPLATES:
        keys = sorted(set(re.findall(r"{(\w)}", t)))
        for vals in itertools.product(*(slots[k] for k in keys)):
            out.add(t.format(**dict(zip(keys, vals))))
    return sorted(out)


def question_pool(seed: int, size: int) -> List[str]:
    """`size` distinct questions drawn from the grammar by the seed."""
    universe = all_questions()
    idx = _rng(seed, 1).choice(len(universe), size=min(size, len(universe)), replace=False)
    return [universe[i] for i in np.sort(idx)]


def _words(text: str) -> List[str]:
    return re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())


def wordpiece_vocab(texts: Sequence[str], split_at: int = 8) -> List[str]:
    """A WordPiece vocabulary for `texts`: the specials, every character and
    its ``##`` form, the words shorter than `split_at` whole, and each longer
    word as a prefix of `split_at` // 2 characters and its ``##`` rest, so
    that the tokenizer has to split them."""
    words, chars = set(), set()
    for t in texts:
        for w in _words(t):
            words.add(w)
            chars.update(w)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += sorted(chars) + ["##" + c for c in sorted(chars)]
    pieces = set()
    for w in sorted(words):
        if len(w) < split_at:
            pieces.add(w)
        else:
            k = split_at // 2
            pieces.update((w[:k], "##" + w[k:]))
    vocab += sorted(p for p in pieces if p not in vocab)
    return vocab


def write_vocab(path: Path, texts: Sequence[str]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(wordpiece_vocab(texts)), encoding="utf-8")
    return path


def answer_list(n: int) -> List[str]:
    """`n` distinct answer strings, already in normalized form."""
    base = [f"{s} {f}" for s in SIDES + ADJ for f in FINDINGS]
    base += [f"{o} {f}" for o in ORGANS for f in FINDINGS]
    base += [f"{a} {o}" for a in ADJ for o in ORGANS]
    if n > len(base):
        raise ValueError(f"at most {len(base)} answers")
    return base[:n]


def images(seed: int, n: int, size: int, stream: int = 2) -> np.ndarray:
    """n uint8 (size, size, 3) images: a coarse random field, upsampled, with
    pixel noise."""
    rng = _rng(seed, stream)
    cell = 16
    g = -(-size // cell)
    coarse = rng.integers(0, 256, (n, g, g, 3), dtype=np.int16)
    img = np.repeat(np.repeat(coarse, cell, axis=1), cell, axis=2)[:, :size, :size]
    img = img + rng.integers(-24, 25, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _support(dist: dict):
    """The values and probabilities of a count distribution:
    {"kind": "fixed", "n": k}, {"kind": "power", "min": a, "max": b,
    "alpha": s} (P(k) proportional to k^-s) or {"kind": "choice",
    "values": [...], "weights": [...]}."""
    kind = dist["kind"]
    if kind == "fixed":
        return np.asarray([int(dist["n"])]), np.ones(1)
    if kind == "power":
        ks = np.arange(int(dist["min"]), int(dist["max"]) + 1)
        p = ks.astype(np.float64) ** -float(dist["alpha"])
    elif kind == "choice":
        ks = np.asarray(dist["values"], np.int64)
        p = np.asarray(dist.get("weights", np.ones(len(ks))), np.float64)
    else:
        raise ValueError(f"unknown count distribution {kind!r}")
    return ks, p / p.sum()


def _quantiles(dist: dict, n: int) -> np.ndarray:
    """n stratified draws (the quantiles at (i + 0.5) / n) of a question
    count distribution (``_support``)."""
    ks, p = _support(dist)
    u = (np.arange(n) + 0.5) / n
    return ks[np.minimum(np.searchsorted(np.cumsum(p), u), len(ks) - 1)]


def count_mean(dist: dict) -> float:
    ks, p = _support(dist)
    return float((ks * p).sum())


def arrival_times(mix: dict, n: int, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """n due times in [0, seconds): stratified exponential gaps in an order
    drawn from the seed, scaled to fill the window, then run through the
    inverse of the cumulative rate of ``phases`` (a piecewise-constant
    relative rate, repeated; absent, a constant rate)."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    unit = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])  # in [0, seconds) at a constant rate
    phases = mix.get("phases")
    if not phases:
        return unit
    dur = np.asarray([p[0] for p in phases], np.float64)
    rel = np.asarray([p[1] for p in phases], np.float64)
    reps = int(np.ceil(seconds / dur.sum())) + 1
    dur, rel = np.tile(dur, reps), np.tile(rel, reps)
    edges = np.concatenate([[0.0], np.cumsum(dur)])
    keep = edges[:-1] < seconds
    dur, rel, edges = dur[keep], rel[keep], edges[: keep.sum() + 1]
    dur[-1] = seconds - edges[-2]
    edges[-1] = seconds
    mass = np.concatenate([[0.0], np.cumsum(dur * rel)])
    mass *= seconds / mass[-1]  # the mean rate stays rate_rps
    k = np.minimum(np.searchsorted(mass, unit, side="right") - 1, len(dur) - 1)
    return edges[k] + (unit - mass[k]) / (mass[k + 1] - mass[k]) * dur[k]


def encode_jpeg(image: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=int(quality))
    return buf.getvalue()


def decode(payload) -> np.ndarray:
    """The uint8 RGB pixels a request's image payload stands for."""
    if isinstance(payload, np.ndarray):
        return payload
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))


class ServeTraffic:
    """The requests of a serve mix, request i being (image, questions).
    Closed loop: as many as the server pulls. Open loop: arrivals at
    ``rate_rps`` on average (``arrival_times``), due at ``due[i]`` seconds
    into the window."""

    def __init__(self, mix: dict, seed: int, seconds: float):
        self.mix, self.seed = mix, int(seed)
        q = mix["questions"]
        self.pool = question_pool(seed, int(q["pool"]))
        self.open = mix["loop"] == "open"
        rng = _rng(seed, 3)
        if self.open:
            n = max(1, int(round(float(mix["rate_rps"]) * seconds)))
            self.due = arrival_times(mix, n, seconds, rng)
        else:
            n = int(mix.get("table_requests", 8192))
            self.due = None
        self.counts = rng.permutation(_quantiles(q["per_request"], n))
        self.n = n
        cap = int(self.counts.max())
        pick = q.get("pick", {"kind": "uniform"})
        if pick["kind"] == "uniform":
            self.qtable = _rng(seed, 4).integers(0, len(self.pool), (n, cap))
        elif pick["kind"] == "zipf":
            w = 1.0 / np.arange(1, len(self.pool) + 1) ** float(pick["s"])
            self.qtable = _rng(seed, 4).choice(len(self.pool), size=(n, cap), p=w / w.sum())
        else:
            raise ValueError(f"unknown question pick {pick['kind']!r}")
        im = mix["images"]
        self.images = images(seed, int(im["distinct"]), int(im["size"]))
        fmt = im.get("format", "uint8")
        if fmt == "jpeg":
            self.payloads = [encode_jpeg(x, im.get("quality", 90)) for x in self.images]
        elif fmt == "uint8":
            self.payloads = list(self.images)
        else:
            raise ValueError(f"unknown image format {fmt!r}")

    def request(self, i: int):
        j = i % self.n
        qs = [self.pool[k] for k in self.qtable[j, : self.counts[j]]]
        return self.payloads[i % len(self.payloads)], qs

    def warmup_requests(self, n: int):
        """n requests with the mix's question counts, from another stream of
        the seed (warm-up only)."""
        rng = _rng(self.seed, 5)
        counts = rng.permutation(_quantiles(self.mix["questions"]["per_request"], n))
        for i in range(n):
            qs = rng.integers(0, len(self.pool), counts[i])
            yield self.payloads[i % len(self.payloads)], [self.pool[k] for k in qs]


# ---- train corpus (VQA-Med 2019 format) ----------------------------------

VQA_MED_CATEGORIES = (
    ("C1_Modality", "modality", ("what modality is shown?", "what kind of scan is this?",
                                 "was this image taken with contrast?", "what imaging method was used?")),
    ("C2_Plane", "plane", ("in what plane is this image taken?", "what plane is this?",
                           "which plane is the image shown in?")),
    ("C3_Organ", "organ", ("what organ system is shown in this image?", "which organ is captured here?",
                           "what part of the body is being imaged?")),
    ("C4_Abnormality", "abnormality", ("what is abnormal in this image?", "what is the primary abnormality?",
                                       "what abnormality is seen in the image?", "is this image abnormal?")),
)


def corpus_answers(n_total: int) -> Dict[str, List[str]]:
    """The answer set of each category; together `n_total` distinct answers."""
    allans = answer_list(n_total)
    sizes = {"modality": 36, "plane": 16, "organ": 10}
    out, off = {}, 0
    for _, cat, _ in VQA_MED_CATEGORIES:
        k = min(sizes[cat], max(1, n_total // 8)) if cat in sizes else n_total - off
        out[cat] = allans[off : off + k]
        off += k
    return out


def write_corpus(mix: dict, seed: int, root: Path, threads: int = 8, write: bool = True) -> dict:
    """Write the train mix's VQA-Med corpus under `root` (Train/ and Test/:
    images/*.jpg and QAPairsByCategory/C*_*.txt, one "image|question|answer"
    line each). Returns {"samples": [(image path, question, answer)] in the
    order the category files list them (sorted file names, then lines),
    "answers": the answer list, "questions": every question text}. With
    `write` false, only returns what it would write."""
    c = mix["corpus"]
    answers = corpus_answers(int(c["answers"]))
    flat_answers = [a for _, cat, _ in VQA_MED_CATEGORIES for a in answers[cat]]
    rng = _rng(seed, 6)
    sizes = np.asarray(c["image_sizes"])
    out = {"answers": flat_answers, "samples": []}
    jobs = []
    for split, n_img in (("Train", int(c["train_images"])), ("Test", int(c["test_images"]))):
        img_dir = root / split / "images"
        cat_dir = root / split / "QAPairsByCategory"
        if write:
            img_dir.mkdir(parents=True, exist_ok=True)
            cat_dir.mkdir(parents=True, exist_ok=True)
        hw = sizes[rng.integers(0, len(sizes), (n_img, 2))]
        for i in range(n_img):
            jobs.append((img_dir / f"synpic{split.lower()}{i}.jpg", int(hw[i, 0]), int(hw[i, 1]), i))
        for fname, cat, templates in VQA_MED_CATEGORIES:
            pool = answers[cat]
            # Zipf-like answer frequencies, as in the real corpus.
            w = 1.0 / np.arange(1, len(pool) + 1) ** 0.8
            a_idx = rng.choice(len(pool), size=n_img, p=w / w.sum())
            t_idx = rng.integers(0, len(templates), n_img)
            lines = [f"synpic{split.lower()}{i}|{templates[t_idx[i]]}|{pool[a_idx[i]]}" for i in range(n_img)]
            if write:
                (cat_dir / f"{fname}_{split.lower()}.txt").write_text("\n".join(lines))
            if split == "Train":
                out["samples"] += [(str(img_dir / f"synpic{split.lower()}{i}.jpg"), templates[t_idx[i]],
                                    pool[a_idx[i]]) for i in range(n_img)]
    quality = int(c.get("jpeg_quality", 90))
    side = int(sizes.max())
    base = images(seed, int(c.get("distinct_images", 256)), side, stream=7) if write else None

    def write_image(job):
        from PIL import Image

        path, h, w, i = job
        # a base image, cropped at an offset of its own and turned by i
        b = np.rot90(base[i % len(base)], (i // len(base)) % 4)
        y, x = (i * 7) % (side - h + 1), (i * 13) % (side - w + 1)
        Image.fromarray(np.ascontiguousarray(b[y : y + h, x : x + w])).save(path, quality=quality)

    if write:
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(write_image, jobs))
    out["questions"] = sorted({q for _, _, ts in VQA_MED_CATEGORIES for q in ts})
    return out


def cached_corpus(mix: dict, seed: int, cache: Path, threads: int = 8) -> dict:
    """``write_corpus``'s corpus, written once for each (corpus parameters,
    seed) into a folder of its own under `cache` and read from there by
    every later run. A lock file keeps concurrent runs (ranks, tests) from
    writing it twice; a folder without its ``complete`` mark is written
    again."""
    key = hashlib.sha1(json.dumps(mix["corpus"], sort_keys=True).encode()).hexdigest()[:12]
    root = Path(cache) / f"{key}-{int(seed)}"
    root.parent.mkdir(parents=True, exist_ok=True)
    with open(root.parent / f"{root.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "complete").exists():
            shutil.rmtree(root, ignore_errors=True)
            write_corpus(mix, seed, root, threads)
            (root / "complete").write_text("")
    return write_corpus(mix, seed, root, threads, write=False)
