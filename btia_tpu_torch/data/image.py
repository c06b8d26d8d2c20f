"""Host-side image decode (JPEG/PNG/DICOM → uint8 RGB) [SURVEY §2.2].

Division of labour [B:5]: the host ONLY decodes bytes and resizes to the
fixed ingest resolution (static shape for jit); the final resize to the
encoder's input size and the normalization run on-device inside the model
(ops/ingest.py). uint8 transfer keeps host→HBM traffic 4× smaller than fp32.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Union

import numpy as np
from PIL import Image

from btia_tpu_torch.data.dicom import DicomError, read_dicom

_DICOM_SUFFIXES = {".dcm", ".dicom"}


def _is_dicom_bytes(data: bytes) -> bool:
    return (len(data) > 132 and data[128:132] == b"DICM") or data[:4] == b"DICM"


def decode_image(src: Union[str, Path, bytes]) -> np.ndarray:
    """Decode JPEG/PNG/BMP/DICOM to (H, W, 3) uint8 RGB."""
    if isinstance(src, (str, Path)):
        path = Path(src)
        data = path.read_bytes()
        if _is_dicom_bytes(data):
            return read_dicom(data).to_rgb_uint8()
        if path.suffix.lower() in _DICOM_SUFFIXES:
            # Suffix hint only (raw datasets lack the 'DICM' magic): a
            # misnamed *.dcm that is really PNG/JPEG falls through to PIL.
            try:
                return read_dicom(data).to_rgb_uint8()
            except DicomError:
                pass
    else:
        data = src
        if _is_dicom_bytes(data):
            return read_dicom(data).to_rgb_uint8()
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Host bilinear resize to (size, size, 3) uint8 (PIL, no antialias
    surprises — the quality-critical resize happens on-device)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    pil = Image.fromarray(img).resize((size, size), Image.BILINEAR)
    return np.asarray(pil, dtype=np.uint8)


def load_ingest_image(src: Union[str, Path, bytes], ingest_size: int) -> np.ndarray:
    """decode → fixed-size uint8 RGB, ready for device_put.

    DICOM goes through the native C++ fused decode+resize when available
    (GIL-free, single pass — the streaming hot path [B:11]); everything
    else / fallback uses the Python reference implementations.
    """
    is_dicom = False
    if isinstance(src, (str, Path)):
        path = Path(src)
        if path.suffix.lower() in _DICOM_SUFFIXES:
            # Keep the suffix hint: raw-dataset DICOMs (no 128-byte
            # preamble / 'DICM' magic) are supported by read_dicom but
            # fail the magic probe — without the hint they'd fall through
            # to PIL and raise UnidentifiedImageError.
            is_dicom = True
            src = path.read_bytes()
    if isinstance(src, bytes) and (is_dicom or _is_dicom_bytes(src)):
        from btia_tpu_torch.data import native

        out = native.dicom_decode_resize(src, ingest_size, ingest_size)
        if out is not None:
            return out
        from btia_tpu_torch.data.dicom import read_dicom as _read

        try:
            return resize_uint8(_read(src).to_rgb_uint8(), ingest_size)
        except DicomError:
            if is_dicom and not _is_dicom_bytes(src):
                # Suffix hint only: a misnamed *.dcm that is really
                # PNG/JPEG falls through to the PIL path below.
                pass
            else:
                raise
    return resize_uint8(decode_image(src), ingest_size)
