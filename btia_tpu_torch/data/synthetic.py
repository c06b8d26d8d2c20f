"""Synthetic VQA fixtures in the real datasets' on-disk formats
[SURVEY §4.2 "tiny synthetic VQA-RAD/SLAKE-format fixtures"].

Generates deterministic JPEG + DICOM images and QA annotations so loaders,
vocab builders, training, and the DICOM path are all exercised without any
real (and license-encumbered) medical data on the machine.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from btia_tpu_torch.data.datasets import VQASample
from btia_tpu_torch.data.dicom import write_dicom

_ORGANS = ["lung", "heart", "liver", "kidney", "brain"]
_MODALITIES = ["xray", "ct", "mri"]
_PLANES = ["axial", "coronal", "sagittal"]

# Visual encodings for the LEARNABLE corpus (VERDICT r2 item 1): every
# label is deterministically rendered into the pixels, so a model that
# attends to the image CAN predict val answers on unseen images —
# unlike the legacy corpus below whose labels were uncorrelated with
# pixel content (val accuracy saturated at chance ≈0.375).
_ORGAN_POS = {  # organ → main-structure center (x_frac, y_frac)
    "lung": (0.28, 0.28),
    "heart": (0.50, 0.50),
    "liver": (0.74, 0.30),
    "kidney": (0.30, 0.74),
    "brain": (0.73, 0.73),
}
_MODALITY_BG = {"xray": 195.0, "ct": 115.0, "mri": 38.0}  # background band
_PLANE_ASPECT = {  # plane → structure aspect (sx, sy) scale factors
    "axial": (1.0, 1.0),
    "coronal": (2.1, 0.55),
    "sagittal": (0.55, 2.1),
}


def _make_image(rng: np.random.RandomState, size: int = 128) -> np.ndarray:
    """Gradient + blobs; grayscale-ish like radiology."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = 60 + 80 * x + 40 * y
    for _ in range(rng.randint(2, 5)):
        cx, cy = rng.rand(2) * size
        r = 8 + rng.rand() * 24
        d2 = (np.mgrid[0:size, 0:size][1] - cx) ** 2 + (
            np.mgrid[0:size, 0:size][0] - cy
        ) ** 2
        img += 70 * np.exp(-d2 / (2 * r * r))
    g = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def _render_learnable(
    rng: np.random.RandomState,
    organ: str,
    modality: str,
    plane: str,
    abnormal: bool,
    size: int = 128,
    second: Optional[tuple] = None,
) -> np.ndarray:
    """Render (organ, modality, plane, abnormal) into pixels, with nuisance
    jitter/noise so val generalization (unseen images) is required:

    - modality → background intensity band (xray bright / ct mid / mri dark)
    - organ    → position of the main elliptical structure (5 sites)
    - plane    → aspect ratio of that structure (round / wide / tall)
    - abnormal → a small maximal-contrast lesion dot inside the structure
    """
    bg = _MODALITY_BG[modality] + rng.randn() * 6
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size), bg, np.float32)
    img += (x / size - 0.5) * rng.randn() * 8  # mild nuisance gradient

    structures = [(organ, abnormal)] + ([second] if second else [])
    for org, abn in structures:
        cx = (_ORGAN_POS[org][0] + rng.uniform(-0.04, 0.04)) * size
        cy = (_ORGAN_POS[org][1] + rng.uniform(-0.04, 0.04)) * size
        sx, sy = _PLANE_ASPECT[plane]
        r = size * (0.11 + rng.uniform(-0.012, 0.012))
        d2 = ((x - cx) / (sx * r)) ** 2 + ((y - cy) / (sy * r)) ** 2
        # Structure contrasts against the band: darker on bright
        # backgrounds, brighter on dark ones — visible for every modality.
        delta = -70.0 if bg > 128 else 70.0
        img += delta * np.exp(-d2 / 2.0)

        if abn:
            # Lesion: near-saturated dot at the structure center, opposite
            # contrast direction to the structure itself.
            lx = cx + rng.uniform(-0.25, 0.25) * r
            ly = cy + rng.uniform(-0.25, 0.25) * r
            lr = size * 0.06  # ≥3.8 px even after a 64-px encoder resize
            ld2 = (x - lx) ** 2 + (y - ly) ** 2
            lesion = 255.0 if bg > 128 else 0.0
            w = np.exp(-ld2 / (2 * lr * lr))
            img = img * (1 - w) + lesion * w

    img += rng.randn(size, size) * 4  # sensor noise
    g = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def _learnable_labels(rng: np.random.RandomState):
    """iid label draw — decorrelated from the image index on purpose."""
    return (
        _ORGANS[rng.randint(len(_ORGANS))],
        _MODALITIES[rng.randint(len(_MODALITIES))],
        _PLANES[rng.randint(len(_PLANES))],
        bool(rng.rand() < 0.5),
    )


def _learnable_qa(
    rng: np.random.RandomState, organ, modality, plane, abnormal
):
    """Four question templates; the plane question asks about the TRUE
    plane w.p. 0.5 (else a random other), so its answer requires fusing
    the plane named in the text with the aspect ratio in the image —
    neither modality alone predicts it."""
    if rng.rand() < 0.5:
        asked = plane
    else:
        others = [p for p in _PLANES if p != plane]
        asked = others[rng.randint(len(others))]
    return [
        ("what organ is shown in this image", organ, "OPEN"),
        ("what imaging modality was used", modality, "OPEN"),
        (f"is this an {asked} view", "yes" if asked == plane else "no", "CLOSED"),
        (f"is the {organ} normal", "no" if abnormal else "yes", "CLOSED"),
    ]


# Large-vocab attribute glyphs (ROADMAP r4 #1 — the AD head's design
# point is LARGE answer vocabularies [B:9 "large answer vocabulary"]).
# Every organ site carries an iid glyph described by three factors; the
# compound answer string "{intensity} {size} {shape}" gives a 45-answer
# vocabulary whose classes are conjunctions that must be read off ONE
# routed site while four iid distractor glyphs superpose in any pooled
# image representation.
_ATTR_SHAPES = ["dot", "ring", "cross", "bar", "column"]
_ATTR_SIZES = ["tiny", "small", "large"]
# Calibrated for learnability at encoder resolution: a 96px ViT input
# sees these at 0.75x, and the first cut (5/8/11 px, alpha 0.45/0.7/1.0)
# measured UNLEARNABLE (val pinned at the 0.017 blind baseline for 40
# epochs across three encoder/LR configs — rings collapse into dots
# below ~5px post-resize and adjacent alphas sit within the rendering
# noise). 7/10/14 px keeps "large" glyphs inside the ~14px organ site
# (sites are >=28px apart) while every factor pair stays separable.
_ATTR_SIZE_PX = {"tiny": 7.0, "small": 10.0, "large": 14.0}  # at size=128
_ATTR_INTENSITIES = ["faint", "moderate", "vivid"]
_ATTR_INTENSITY_FRAC = {"faint": 0.35, "moderate": 0.65, "vivid": 1.0}


def _glyph_mask(
    x: np.ndarray,
    y: np.ndarray,
    cx: float,
    cy: float,
    shape: str,
    r: float,
    max_len: float = 1e9,
) -> np.ndarray:
    """Soft-edged [0,1] mask for one glyph (super-gaussians: sharp enough
    to survive the encoder resize, smooth enough to not alias).

    ``max_len`` clamps the elongated shapes' half-length so a 'large'
    bar/cross/column cannot reach a neighboring organ site (ADVICE r4):
    with max_len = 14·(size/128), site jitter ±0.02 and glyph offset
    ±0.06·site_r, the worst-case midpoint between two adjacent glyph
    centers (≥32.9 px apart) sees mask ≤ e^-((16.4/14)^8) ≈ 0.03 —
    below the σ=4 sensor noise, so cross-site contamination is bounded
    by the noise floor rather than merely rare."""
    dx, dy = x - cx, y - cy
    d2 = dx * dx + dy * dy
    t = max(2.0, 0.35 * r)  # stroke thickness (thin enough that a
    # "tiny" ring keeps a visible hole after the encoder resize)

    def _bar(along, across, length):
        return np.exp(-((across / t) ** 4) - ((along / length) ** 8))

    if shape == "dot":
        return np.exp(-((d2 / (r * r)) ** 4))
    if shape == "ring":
        return np.exp(-(((np.sqrt(d2) - r) / (0.55 * t)) ** 2))
    if shape == "cross":
        return np.maximum(
            _bar(dx, dy, min(1.3 * r, max_len)),
            _bar(dy, dx, min(1.3 * r, max_len)),
        )
    if shape == "bar":  # horizontal
        return _bar(dx, dy, min(1.5 * r, max_len))
    if shape == "column":  # vertical
        return _bar(dy, dx, min(1.5 * r, max_len))
    raise ValueError(shape)


def _largevocab_labels(rng: np.random.RandomState, sites: int = 0):
    """``sites`` < 5 keeps a random subset of organ sites (the reading
    curriculum's stage A renders ONE site so the glyph signal survives
    soft attention pooling — see learnability.py --curriculum). The
    default draws are stream-identical to the original generator."""
    per_organ = {
        o: (
            _ATTR_SHAPES[rng.randint(len(_ATTR_SHAPES))],
            _ATTR_SIZES[rng.randint(len(_ATTR_SIZES))],
            _ATTR_INTENSITIES[rng.randint(len(_ATTR_INTENSITIES))],
        )
        for o in _ORGANS
    }
    modality = _MODALITIES[rng.randint(len(_MODALITIES))]
    if 0 < sites < len(_ORGANS):
        idx = rng.choice(len(_ORGANS), size=sites, replace=False)
        keep = {_ORGANS[i] for i in idx}
        per_organ = {o: v for o, v in per_organ.items() if o in keep}
    return per_organ, modality


def _render_largevocab(
    rng: np.random.RandomState,
    per_organ: dict,
    modality: str,
    size: int = 128,
) -> np.ndarray:
    """All five organ sites rendered, each with an iid attribute glyph —
    the question's organ slot selects which site's conjunction to read."""
    bg = _MODALITY_BG[modality] + rng.randn() * 6
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size), bg, np.float32)
    img += (x / size - 0.5) * rng.randn() * 8

    target = 255.0 if bg > 128 else 0.0  # glyph contrast direction
    for organ, (shape, size_word, intensity) in per_organ.items():
        # Jitters tightened vs the learnable corpus (±0.03 site, ±0.12
        # glyph) so elongated 'large' glyphs stay clear of neighboring
        # sites — see the contamination bound in _glyph_mask.
        cx = (_ORGAN_POS[organ][0] + rng.uniform(-0.02, 0.02)) * size
        cy = (_ORGAN_POS[organ][1] + rng.uniform(-0.02, 0.02)) * size
        site_r = size * (0.11 + rng.uniform(-0.01, 0.01))
        d2 = ((x - cx) / site_r) ** 2 + ((y - cy) / site_r) ** 2
        delta = -70.0 if bg > 128 else 70.0
        img += delta * np.exp(-d2 / 2.0)

        r = _ATTR_SIZE_PX[size_word] * (size / 128.0) * rng.uniform(0.92, 1.08)
        gx = cx + rng.uniform(-0.06, 0.06) * site_r
        gy = cy + rng.uniform(-0.06, 0.06) * site_r
        w = _glyph_mask(x, y, gx, gy, shape, r, max_len=14.0 * size / 128.0)
        alpha = _ATTR_INTENSITY_FRAC[intensity]
        img = img * (1 - w * alpha) + target * w * alpha

    img += rng.randn(size, size) * 4
    g = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def _largevocab_qa(rng: np.random.RandomState, per_organ: dict):
    """Four routed questions per image (distinct organs); the answer is
    the asked site's attribute conjunction — vocab = 3 intensities ×
    3 sizes × 5 shapes = 45 compound answers, all OPEN. Four reads per
    render (vs the original two) doubles the routing supervision each
    image provides, which the from-scratch encoder needs to generalize
    glyph attributes to unseen images. With a site-subset corpus
    (curriculum stage A) every rendered site is asked."""
    organs = list(per_organ)
    k = min(4, len(organs))
    idx = rng.choice(len(organs), size=k, replace=False)
    out = []
    for organ in (organs[i] for i in idx):
        shape, size_word, intensity = per_organ[organ]
        out.append(
            (
                f"what abnormality is in the {organ}",
                f"{intensity} {size_word} {shape}",
                "OPEN",
            )
        )
    return out


def _compositional_labels(rng: np.random.RandomState):
    """Two DISTINCT organs, each independently abnormal — the question
    must SELECT which organ's site to inspect [VERDICT r3 #6]."""
    i, j = rng.choice(len(_ORGANS), size=2, replace=False)
    modality = _MODALITIES[rng.randint(len(_MODALITIES))]
    return (
        _ORGANS[i],
        bool(rng.rand() < 0.5),
        _ORGANS[j],
        bool(rng.rand() < 0.5),
        modality,
    )


def _compositional_qa(o1, a1, o2, a2, modality):
    """The answer to 'is the {organ} normal' is a function of an image
    attribute (lesion at a SITE) selected by a question slot (the organ
    word) — a model without question→image attention cannot route the
    query to the right site and caps at the per-template majority; the
    BTIA fusion block answers it structurally. 'which organ is abnormal'
    composes both reads. One anchor question (modality) stays
    non-compositional."""
    if a1 and a2:
        which = "both"
    elif a1 or a2:
        which = o1 if a1 else o2
    else:
        which = "none"
    return [
        (f"is the {o1} normal", "no" if a1 else "yes", "CLOSED"),
        (f"is the {o2} normal", "no" if a2 else "yes", "CLOSED"),
        ("which organ is abnormal", which, "OPEN"),
        ("what imaging modality was used", modality, "OPEN"),
    ]


def generate_synthetic_dataset(
    root: Optional[Path] = None,
    num_images: int = 6,
    qa_per_image: int = 4,
    seed: int = 0,
    learnable: bool = False,
    val_frac: float = 0.25,
    compositional: bool = False,
    largevocab: bool = False,
    largevocab_sites: int = 0,
) -> Dict[str, List[VQASample]]:
    """Write a VQA-RAD-format corpus (JPEGs + 1 DICOM + JSON) and load it.

    learnable=False (legacy fixtures): labels are index-derived and
    UNCORRELATED with pixel content — fine for loader/pipeline/CLI tests,
    useless for accuracy claims (val saturates at chance).

    learnable=True: labels are iid draws rendered into the pixels
    (`_render_learnable`), and the test split holds out whole UNSEEN
    images (the last `val_frac` of them), so val accuracy measures
    generalization of a real multimodal mapping. Used by
    benchmarks/learnability.py and tests/test_learnability.py.

    compositional=True (implies learnable rendering): every image holds
    TWO organ structures with independent lesions; 'is the {organ}
    normal' requires routing the question's organ slot to that organ's
    image site [VERDICT r3 #6] — the task the BTIA fusion block exists
    for. Plane is fixed axial (round structures never overlap).

    largevocab=True (implies learnable splits): all FIVE organ sites
    carry iid attribute glyphs; 'what abnormality is in the {organ}'
    has a 45-answer compound vocabulary ({intensity} {size} {shape}) —
    the AD head's design point [B:9, ROADMAP r4 #1]. Four distractor
    glyphs per image make any pooled image read a superposition.
    largevocab_sites limits each image to a random subset of sites
    (stage A of the reading curriculum — see learnability.py).
    """
    if compositional or largevocab:
        learnable = True
    if root is None:
        root = Path(tempfile.gettempdir()) / f"btia_synth_{seed}_{num_images}"
    root = Path(root)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)

    n_train_imgs = num_images - max(1, int(round(num_images * val_frac)))
    items = []
    for i in range(num_images):
        if largevocab:
            per_organ, modality = _largevocab_labels(rng, largevocab_sites)
            arr = _render_largevocab(rng, per_organ, modality)
        elif compositional:
            o1, a1, o2, a2, modality = _compositional_labels(rng)
            arr = _render_learnable(
                rng, o1, modality, "axial", a1, second=(o2, a2)
            )
        elif learnable:
            organ, modality, plane, abnormal = _learnable_labels(rng)
            arr = _render_learnable(rng, organ, modality, plane, abnormal)
        else:
            arr = _make_image(rng)
            organ = _ORGANS[i % len(_ORGANS)]
            modality = _MODALITIES[i % len(_MODALITIES)]
            plane = _PLANES[i % len(_PLANES)]
        if i == 0:
            # One DICOM image exercises the DICOM ingest path [B:11].
            name = f"synpic{i}.dcm"
            px = (arr[:, :, 0].astype(np.uint16) * 16)
            write_dicom(img_dir / name, px, window=(2048.0, 4096.0))
        else:
            name = f"synpic{i}.jpg"
            Image.fromarray(arr).save(img_dir / name, quality=92)

        if largevocab:
            qa = _largevocab_qa(rng, per_organ)[:qa_per_image]
        elif compositional:
            qa = _compositional_qa(o1, a1, o2, a2, modality)[:qa_per_image]
        elif learnable:
            qa = _learnable_qa(rng, organ, modality, plane, abnormal)[
                :qa_per_image
            ]
        else:
            qa = [
                (f"is the {organ} normal", "yes" if i % 2 == 0 else "no", "CLOSED"),
                (f"what organ is shown in this image", organ, "OPEN"),
                (f"what imaging modality was used", modality, "OPEN"),
                (f"is this an {plane} view", "yes" if i % 3 == 0 else "no", "CLOSED"),
            ][:qa_per_image]
        for j, (q, a, at) in enumerate(qa):
            if learnable:
                # Whole images are held out — val requires generalizing
                # the visual encoding, not recalling a seen image.
                is_test = i >= n_train_imgs
            else:
                # ~1/3 of items become the test split, marked VQA-RAD-style.
                is_test = (i * qa_per_image + j) % 3 == 2
            items.append(
                {
                    "qid": i * qa_per_image + j,
                    "image_name": name,
                    "question": q,
                    "answer": a,
                    "answer_type": at,
                    "phrase_type": "test_freeform" if is_test else "freeform",
                }
            )

    (root / "vqa_rad.json").write_text(json.dumps(items, indent=1))

    from btia_tpu_torch.data.datasets import load_vqa_rad

    return {
        "train": load_vqa_rad(root, "train"),
        "val": load_vqa_rad(root, "test"),
        "test": load_vqa_rad(root, "test"),
    }


def _qa_for(i: int):
    organ = _ORGANS[i % len(_ORGANS)]
    modality = _MODALITIES[i % len(_MODALITIES)]
    return organ, modality


def generate_synthetic_slake(root: Path, num_images: int = 4, seed: int = 1):
    """SLAKE on-disk format [B:8]: train/validate/test.json + imgs/."""
    root = Path(root)
    img_dir = root / "imgs"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(num_images):
        name = f"xmlab{i}.jpg"
        Image.fromarray(_make_image(rng)).save(img_dir / name, quality=90)
        names.append(name)

    def items(split_seed):
        out = []
        for i, name in enumerate(names):
            organ, modality = _qa_for(i + split_seed)
            out += [
                {"img_name": name, "question": f"what organ is this",
                 "answer": organ, "q_lang": "en", "answer_type": "OPEN",
                 "content_type": "organ", "qid": i * 10 + split_seed},
                {"img_name": name, "question": "这是什么器官",
                 "answer": organ, "q_lang": "zh", "answer_type": "OPEN",
                 "content_type": "organ", "qid": i * 10 + split_seed + 1},
                {"img_name": name, "question": "is this an mri scan",
                 "answer": "yes" if modality == "mri" else "no",
                 "q_lang": "en", "answer_type": "CLOSED",
                 "content_type": "modality", "qid": i * 10 + split_seed + 2},
            ]
        return out

    (root / "train.json").write_text(json.dumps(items(0)))
    (root / "validate.json").write_text(json.dumps(items(3)))
    (root / "test.json").write_text(json.dumps(items(6)))
    return root


def generate_synthetic_pathvqa(root: Path, num_images: int = 4, seed: int = 2):
    """PathVQA format [B:9]: {split}.json + images/."""
    root = Path(root)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for split in ("train", "val", "test"):
        items = []
        for i in range(num_images):
            name = f"path_{split}_{i}"
            Image.fromarray(_make_image(rng)).save(
                img_dir / f"{name}.jpg", quality=90
            )
            organ, _ = _qa_for(i)
            items += [
                {"image": name, "question": "what tissue is shown",
                 "answer": f"{organ} tissue"},
                {"image": name, "question": "is there a tumor present",
                 "answer": "yes" if i % 2 else "no"},
            ]
        (root / f"{split}.json").write_text(json.dumps(items))
    return root


def generate_synthetic_vqa_med(root: Path, num_images: int = 4, seed: int = 3):
    """VQA-Med / ImageCLEF-2019 format [B:10]: QAPairsByCategory txts."""
    root = Path(root)
    # Static per-split offsets: str hash() is randomized per process
    # (PYTHONHASHSEED), which silently broke the "deterministic fixtures"
    # contract across processes.
    split_offsets = {"Train": 0, "Val": 1, "Test": 2}
    for split in ("Train", "Val", "Test"):
        split_dir = root / split
        img_dir = split_dir / "images"
        cat_dir = split_dir / "QAPairsByCategory"
        img_dir.mkdir(parents=True, exist_ok=True)
        cat_dir.mkdir(parents=True, exist_ok=True)
        rng = np.random.RandomState(seed + split_offsets[split])
        c1, c3 = [], []
        for i in range(num_images):
            name = f"synpic{split.lower()}{i}"
            Image.fromarray(_make_image(rng)).save(
                img_dir / f"{name}.jpg", quality=90
            )
            organ, modality = _qa_for(i)
            c1.append(f"{name}|what modality was used|{modality}")
            c3.append(f"{name}|what organ is captured|{organ}")
        (cat_dir / "C1_Modality.txt").write_text("\n".join(c1))
        (cat_dir / "C3_Organ.txt").write_text("\n".join(c3))
    return root
