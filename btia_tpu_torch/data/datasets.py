"""Dataset loaders: VQA-RAD, SLAKE, PathVQA, VQA-Med (ImageCLEF 2019)
[B:7–B:10; SURVEY §2.2].

Each loader parses the dataset's published on-disk format into a flat list
of `VQASample`s; vocabularies are built downstream (data/vocab.py) and the
iterator (data/pipeline.py) does decode/batch. A 'synthetic' dataset
generates fixtures in the same formats for tests [SURVEY §4.2].
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from btia_tpu_torch.configs.config import DataConfig


@dataclasses.dataclass
class VQASample:
    image_path: str
    question: str
    answer: str
    answer_type: str = "OPEN"  # OPEN | CLOSED
    category: str = ""  # VQA-Med question category [B:10]
    qid: str = ""


Split = List[VQASample]


def _read_json(path: Path):
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# VQA-RAD [B:7] — single JSON; test items are flagged in phrase_type.
# ---------------------------------------------------------------------------


def load_vqa_rad(root: Path, split: str) -> Split:
    candidates = [
        root / "VQA_RAD Dataset Public.json",
        root / "vqa_rad.json",
        root / "trainset.json" if split == "train" else root / "testset.json",
    ]
    img_root = root / "images" if (root / "images").is_dir() else root
    for cand in candidates:
        if cand.exists():
            items = _read_json(cand)
            break
    else:
        raise FileNotFoundError(f"no VQA-RAD annotations under {root}")

    out: Split = []
    for it in items:
        phrase = str(it.get("phrase_type", "")).lower()
        is_test = phrase.startswith("test")
        if (split == "train") == is_test and "phrase_type" in it:
            continue
        out.append(
            VQASample(
                image_path=str(img_root / it["image_name"]),
                question=str(it.get("question", "")),
                answer=str(it.get("answer", "")),
                answer_type=str(it.get("answer_type", "OPEN")).upper(),
                qid=str(it.get("qid", len(out))),
            )
        )
    return out


# ---------------------------------------------------------------------------
# SLAKE [B:8] — train/validate/test.json; bilingual, filter q_lang.
# ---------------------------------------------------------------------------


def load_slake(root: Path, split: str, language: str = "en") -> Split:
    names = {"train": "train.json", "val": "validate.json", "test": "test.json"}
    items = _read_json(root / names[split])
    img_root = root / "imgs" if (root / "imgs").is_dir() else root
    out: Split = []
    for it in items:
        if language and str(it.get("q_lang", "en")).lower() != language:
            continue
        out.append(
            VQASample(
                image_path=str(img_root / it["img_name"]),
                question=str(it["question"]),
                answer=str(it["answer"]),
                answer_type=str(it.get("answer_type", "OPEN")).upper(),
                category=str(it.get("content_type", "")),
                qid=str(it.get("qid", len(out))),
            )
        )
    return out


# ---------------------------------------------------------------------------
# PathVQA [B:9] — {split}.json lists of {image, question, answer}.
# ---------------------------------------------------------------------------


def load_pathvqa(root: Path, split: str) -> Split:
    items = _read_json(root / f"{split}.json")
    img_root = root / "images" if (root / "images").is_dir() else root
    out: Split = []
    for it in items:
        img = it.get("image", it.get("img_name", ""))
        if img and not Path(img).suffix:
            img += ".jpg"
        ans = str(it.get("answer", ""))
        out.append(
            VQASample(
                image_path=str(img_root / img),
                question=str(it["question"]),
                answer=ans,
                answer_type="CLOSED" if ans.lower() in ("yes", "no") else "OPEN",
                qid=str(it.get("qid", len(out))),
            )
        )
    return out


# ---------------------------------------------------------------------------
# VQA-Med / ImageCLEF 2019 [B:10] — pipe-separated txts, per-category files.
# ---------------------------------------------------------------------------

_VQA_MED_CATEGORIES = {
    "c1": "modality",
    "c2": "plane",
    "c3": "organ",
    "c4": "abnormality",
}


def load_vqa_med(root: Path, split: str) -> Split:
    split_dir_names = {
        "train": ["Train", "train"],
        "val": ["Val", "val", "Validation"],
        "test": ["Test", "test"],
    }
    split_dir = root
    for name in split_dir_names[split]:
        if (root / name).is_dir():
            split_dir = root / name
            break

    img_root = None
    for name in ("images", f"{split}_images", "Train_images", "Val_images"):
        if (split_dir / name).is_dir():
            img_root = split_dir / name
            break
    img_root = img_root or split_dir

    out: Split = []

    def parse_file(path: Path, category: str):
        for line in path.read_text().splitlines():
            parts = line.split("|")
            if len(parts) < 3:
                continue
            img, rest = parts[0].strip(), parts[1:]
            if len(rest) >= 3 and rest[0].strip().lower() in _VQA_MED_CATEGORIES.values():
                cat, question, answer = rest[0], rest[1], rest[2]
            else:
                cat, question, answer = category, rest[0], rest[1]
            img_file = img if Path(img).suffix else img + ".jpg"
            out.append(
                VQASample(
                    image_path=str(img_root / img_file),
                    question=question.strip(),
                    answer=answer.strip(),
                    answer_type="OPEN",
                    category=cat.strip().lower(),
                    qid=f"{img}-{len(out)}",
                )
            )

    cat_dir = split_dir / "QAPairsByCategory"
    if cat_dir.is_dir():
        for f in sorted(cat_dir.glob("*.txt")):
            key = f.name.split("_")[0].lower()
            parse_file(f, _VQA_MED_CATEGORIES.get(key, key))
    else:
        candidates = list(split_dir.glob("*QA*Pairs*.txt")) or list(
            split_dir.glob("*.txt")
        )
        if not candidates:
            raise FileNotFoundError(f"no VQA-Med QA files under {split_dir}")
        for f in sorted(candidates):
            parse_file(f, "unknown")
    return out


# ---------------------------------------------------------------------------


def load_dataset(cfg: DataConfig, split: str) -> Split:
    root = Path(cfg.data_dir)
    if cfg.dataset == "vqa_rad":
        samples = load_vqa_rad(root, split)
        if cfg.closed_only:
            samples = [s for s in samples if s.answer_type == "CLOSED"]
        return samples
    if cfg.dataset == "slake":
        return load_slake(root, split, cfg.language)
    if cfg.dataset == "pathvqa":
        return load_pathvqa(root, split)
    if cfg.dataset == "vqa_med":
        return load_vqa_med(root, split)
    if cfg.dataset == "synthetic":
        from btia_tpu_torch.data.synthetic import generate_synthetic_dataset

        root = root if cfg.data_dir else None
        return generate_synthetic_dataset(root)[split]
    raise KeyError(f"unknown dataset {cfg.dataset!r}")
