"""Minimal DICOM reader/writer — covers the ingest path [B:5, B:11].

pydicom is not available in this environment [SURVEY §7.1], so this module
implements the slice of DICOM the medical-VQA ingest actually needs:

  * Part-10 files (128-byte preamble + 'DICM') and raw datasets;
  * explicit- and implicit-VR little endian transfer syntaxes;
  * deflated explicit VR LE (zlib);
  * uncompressed PixelData, 8/16-bit, signed/unsigned, MONOCHROME1/2 + RGB;
  * encapsulated PixelData (fragment item sequences) for the JPEG-family
    syntaxes that dominate real PACS exports: JPEG baseline/extended
    (PIL decode), JPEG 2000 lossless/lossy (PIL/OpenJPEG), and RLE
    lossless (self-contained PackBits codec below);
  * multi-frame PixelData (uncompressed contiguous frames and one
    fragment per frame when encapsulated);
  * rescale slope/intercept and window center/width → display uint8.

Malformed or truncated files raise ValueError (never struct.error or
IndexError) — a corrupt file must not crash a streaming decode thread
[VERDICT r1 item 4].

Unsupported syntaxes (JPEG-LS, MPEG, ...) raise a clear error naming the
syntax. The native C++ fast path (native/btia_ingest.cc) handles only
uncompressed single-frame data; everything here is its fallback.
"""

from __future__ import annotations

import dataclasses
import io
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# Tags we care about: (group, element)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_PHOTOMETRIC = (0x0028, 0x0004)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_NUMBER_OF_FRAMES = (0x0028, 0x0008)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_WINDOW_CENTER = (0x0028, 0x1050)
TAG_WINDOW_WIDTH = (0x0028, 0x1051)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"

_JPEG_SYNTAXES = {JPEG_BASELINE, JPEG_EXTENDED, JPEG2000_LOSSLESS, JPEG2000}
ENCAPSULATED_SYNTAXES = _JPEG_SYNTAXES | {RLE_LOSSLESS}
SUPPORTED_SYNTAXES = ENCAPSULATED_SYNTAXES | {
    EXPLICIT_VR_LE,
    IMPLICIT_VR_LE,
    DEFLATED_EXPLICIT_VR_LE,
}

# VRs with a 4-byte length field (and 2 reserved bytes) in explicit VR.
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"UC", b"UR"}

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)
_UNDEFINED = 0xFFFFFFFF


class DicomError(ValueError):
    """Malformed, truncated, or unsupported DICOM input."""


@dataclasses.dataclass
class DicomImage:
    pixels: np.ndarray  # (H, W) or (H, W, 3), raw stored values
    photometric: str = "MONOCHROME2"
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    window_center: Optional[float] = None
    window_width: Optional[float] = None
    num_frames: int = 1

    def to_uint8(self) -> np.ndarray:
        """Apply rescale + window (or min/max) → display uint8 (H, W[, 3])."""
        px = self.pixels.astype(np.float32)
        if self.photometric.startswith("MONOCHROME"):
            px = px * self.rescale_slope + self.rescale_intercept
            if self.window_center is not None and self.window_width:
                lo = self.window_center - self.window_width / 2.0
                hi = self.window_center + self.window_width / 2.0
            else:
                lo, hi = float(px.min()), float(px.max())
            if hi <= lo:
                hi = lo + 1.0
            px = np.clip((px - lo) / (hi - lo), 0.0, 1.0)
            if self.photometric == "MONOCHROME1":  # inverted scale
                px = 1.0 - px
            return (px * 255.0 + 0.5).astype(np.uint8)
        return np.clip(px, 0, 255).astype(np.uint8)

    def to_rgb_uint8(self) -> np.ndarray:
        u8 = self.to_uint8()
        if u8.ndim == 2:
            u8 = np.repeat(u8[:, :, None], 3, axis=2)
        return u8


# ---------------------------------------------------------------------------
# Element parsing
# ---------------------------------------------------------------------------


def _read_fragments(buf: bytes, pos: int) -> Tuple[List[bytes], int]:
    """Parse an encapsulated-PixelData item sequence starting at `pos`
    (just past the undefined-length element header): Basic Offset Table
    item first, then one item per fragment, terminated by (FFFE,E0DD)."""
    n = len(buf)
    items: List[bytes] = []
    while True:
        if pos + 8 > n:
            raise DicomError("truncated encapsulated PixelData item sequence")
        group, elem, length = struct.unpack_from("<HHI", buf, pos)
        pos += 8
        if (group, elem) == _SEQ_DELIM:
            break
        if (group, elem) != _ITEM:
            raise DicomError(
                f"unexpected tag ({group:04x},{elem:04x}) in PixelData items"
            )
        if length == _UNDEFINED or pos + length > n:
            raise DicomError("bad encapsulated fragment length")
        items.append(buf[pos : pos + length])
        pos += length
    if not items:
        raise DicomError("encapsulated PixelData with no items")
    # items[0] is the Basic Offset Table (possibly empty); rest = fragments.
    return items[1:], pos


def _skip_undefined_sq(buf: bytes, pos: int) -> int:
    """Skip an undefined-length (SQ) element's items. Defined-length items
    only; nested undefined-length items raise (out of ingest scope)."""
    n = len(buf)
    while True:
        if pos + 8 > n:
            raise DicomError("truncated undefined-length sequence")
        group, elem, length = struct.unpack_from("<HHI", buf, pos)
        pos += 8
        if (group, elem) == _SEQ_DELIM:
            return pos
        if (group, elem) != _ITEM or length == _UNDEFINED:
            raise DicomError(
                "unsupported nested undefined-length sequence item"
            )
        if pos + length > n:
            raise DicomError("truncated sequence item")
        pos += length


def _parse_elements(
    buf: bytes,
    offset: int,
    explicit: bool,
    stop_at_pixels: bool = False,
    encapsulated: bool = False,
    meta_only: bool = False,
) -> Tuple[Dict[Tuple[int, int], bytes], Optional[List[bytes]], int]:
    """Parse data elements from offset. Returns (tag → raw value,
    encapsulated pixel fragments or None, end position)."""
    out: Dict[Tuple[int, int], bytes] = {}
    fragments: Optional[List[bytes]] = None
    n = len(buf)
    pos = offset
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if meta_only and group != 0x0002:
            break
        pos += 4
        # File-meta group (0002) is always explicit VR.
        is_explicit = explicit or group == 0x0002
        if is_explicit:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                if pos + 8 > n:
                    raise DicomError("truncated element header")
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                if pos + 4 > n:
                    raise DicomError("truncated element header")
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            if pos + 4 > n:
                raise DicomError("truncated element header")
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == _UNDEFINED:
            if (group, elem) == TAG_PIXEL_DATA:
                if not encapsulated:
                    raise DicomError(
                        "undefined-length PixelData in an uncompressed "
                        "transfer syntax"
                    )
                fragments, pos = _read_fragments(buf, pos)
                break
            pos = _skip_undefined_sq(buf, pos)
            continue
        if pos + length > n:
            raise DicomError(
                f"element ({group:04x},{elem:04x}) overruns file "
                f"(len={length})"
            )
        out[(group, elem)] = buf[pos : pos + length]
        pos += length
        if stop_at_pixels and (group, elem) == TAG_PIXEL_DATA:
            break
    return out, fragments, pos


def _ascii(v: bytes) -> str:
    return v.decode("ascii", errors="ignore").strip("\x00 ").strip()


def _first_float(v: bytes) -> Optional[float]:
    s = _ascii(v).split("\\")[0].strip()
    try:
        return float(s)
    except ValueError:
        return None


def _u16(v: bytes, what: str = "US element") -> int:
    if len(v) < 2:
        raise DicomError(f"{what} shorter than 2 bytes")
    return struct.unpack("<H", v[:2])[0]


def _int_str(v: bytes, default: int) -> int:
    s = _ascii(v)
    try:
        return int(s)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Fragment decoders
# ---------------------------------------------------------------------------


def _decode_jpeg_frame(frag: bytes) -> np.ndarray:
    """JPEG baseline/extended/2000 via PIL → (H, W) or (H, W, 3)."""
    from PIL import Image

    try:
        img = Image.open(io.BytesIO(frag))
        img.load()
    except Exception as e:
        raise DicomError(f"JPEG fragment decode failed: {e}") from e
    if img.mode in ("I;16", "I;16L", "I;16B", "I"):
        return np.asarray(img, dtype=np.uint16)
    if img.mode == "L":
        return np.asarray(img, dtype=np.uint8)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    """PackBits (DICOM RLE segment) decode → exactly `expected` bytes."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        c = data[i]
        i += 1
        if c < 128:  # literal run of c+1 bytes
            j = i + c + 1
            if j > n:
                raise DicomError("truncated RLE literal run")
            out += data[i:j]
            i = j
        elif c > 128:  # replicate next byte 257-c times
            if i >= n:
                raise DicomError("truncated RLE replicate run")
            out += bytes([data[i]]) * (257 - c)
            i += 1
        # c == 128: no-op
    if len(out) < expected:
        raise DicomError("RLE segment shorter than expected")
    return bytes(out[:expected])


def _decode_rle_frame(
    frag: bytes, rows: int, cols: int, samples: int, bits: int
) -> np.ndarray:
    """DICOM RLE (Annex G): 64-byte header (num_segments + 15 offsets),
    one PackBits segment per (sample, byte-plane), MSB plane first."""
    if len(frag) < 64:
        raise DicomError("RLE frame shorter than its 64-byte header")
    header = struct.unpack_from("<16I", frag, 0)
    nseg = header[0]
    bytes_per = 1 if bits == 8 else 2
    if nseg != samples * bytes_per or nseg > 15:
        raise DicomError(
            f"RLE segment count {nseg} != samples({samples})*bytes({bytes_per})"
        )
    plane_len = rows * cols
    offsets = list(header[1 : 1 + nseg]) + [len(frag)]
    planes = []
    for s in range(nseg):
        lo, hi = offsets[s], offsets[s + 1]
        if not (64 <= lo <= hi <= len(frag)):
            raise DicomError("bad RLE segment offsets")
        planes.append(
            np.frombuffer(
                _packbits_decode(frag[lo:hi], plane_len), dtype=np.uint8
            )
        )
    if bits == 8:
        px = np.stack(planes, axis=-1) if samples > 1 else planes[0]
        return px.reshape((rows, cols, samples) if samples > 1 else (rows, cols))
    # 16-bit: per sample, plane pairs are (MSB, LSB).
    out = []
    for s in range(samples):
        msb = planes[2 * s].astype(np.uint16)
        lsb = planes[2 * s + 1].astype(np.uint16)
        out.append((msb << 8) | lsb)
    px = np.stack(out, axis=-1) if samples > 1 else out[0]
    return px.reshape((rows, cols, samples) if samples > 1 else (rows, cols))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def read_dicom(data: Union[bytes, str, Path], frame: int = 0) -> DicomImage:
    """Parse DICOM bytes → DicomImage for the requested frame."""
    if not isinstance(data, bytes):
        data = Path(data).read_bytes()
    if len(data) > 132 and data[128:132] == b"DICM":
        meta_start = 132
    elif data[:4] == b"DICM":
        meta_start = 4
    else:
        meta_start = 0  # raw dataset

    try:
        return _read_parsed(data, meta_start, frame)
    except DicomError:
        raise
    except (struct.error, IndexError, KeyError) as e:
        raise DicomError(f"malformed DICOM: {e}") from e


def _read_parsed(data: bytes, meta_start: int, frame: int) -> DicomImage:
    if meta_start:
        meta, _, body_start = _parse_elements(
            data, meta_start, explicit=True, meta_only=True
        )
        ts = _ascii(meta.get(TAG_TRANSFER_SYNTAX, EXPLICIT_VR_LE.encode()))
        if ts not in SUPPORTED_SYNTAXES:
            raise DicomError(
                f"unsupported DICOM transfer syntax {ts!r} "
                "(supported: uncompressed LE, deflated, JPEG baseline/"
                "extended, JPEG 2000, RLE lossless)"
            )
        body = data
        if ts == DEFLATED_EXPLICIT_VR_LE:
            try:
                body = zlib.decompress(data[body_start:], -15)
            except zlib.error as e:
                raise DicomError(f"deflated dataset inflate failed: {e}") from e
            body_start = 0
            ts = EXPLICIT_VR_LE
        explicit = ts != IMPLICIT_VR_LE
        elements, fragments, _ = _parse_elements(
            body,
            body_start,
            explicit=explicit,
            stop_at_pixels=True,
            encapsulated=ts in ENCAPSULATED_SYNTAXES,
        )
    else:
        # Raw dataset: sniff explicit VR (elements start with printable VR).
        ts = EXPLICIT_VR_LE
        vr_probe = data[4:6]
        explicit = vr_probe.isalpha() and vr_probe.isupper()
        elements, fragments, _ = _parse_elements(
            data, 0, explicit, stop_at_pixels=True
        )

    if TAG_ROWS not in elements or TAG_COLS not in elements:
        raise DicomError("missing Rows/Columns")
    rows = _u16(elements[TAG_ROWS], "Rows")
    cols = _u16(elements[TAG_COLS], "Columns")
    bits = _u16(elements.get(TAG_BITS_ALLOCATED, b"\x08\x00"), "BitsAllocated")
    signed = (
        _u16(elements.get(TAG_PIXEL_REPRESENTATION, b"\x00\x00"), "PixelRep")
        == 1
    )
    samples = _u16(
        elements.get(TAG_SAMPLES_PER_PIXEL, b"\x01\x00"), "SamplesPerPixel"
    )
    num_frames = max(
        1, _int_str(elements.get(TAG_NUMBER_OF_FRAMES, b"1"), 1)
    )
    photometric = _ascii(
        elements.get(TAG_PHOTOMETRIC, b"MONOCHROME2")
    ) or "MONOCHROME2"
    if rows <= 0 or cols <= 0:
        raise DicomError(f"bad image dims {rows}x{cols}")
    if bits not in (8, 16):
        raise DicomError(f"unsupported BitsAllocated={bits}")
    if samples not in (1, 3):
        raise DicomError(f"unsupported SamplesPerPixel={samples}")
    if not (0 <= frame < num_frames):
        raise DicomError(f"frame {frame} out of range (NumberOfFrames={num_frames})")

    if fragments is not None:
        px = _decode_encapsulated(
            fragments, ts, frame, num_frames, rows, cols, samples, bits
        )
        # Encapsulated decoders (RLE planes, PIL for J2K 16-bit) produce
        # unsigned arrays; PixelRepresentation=1 means the stored bits ARE
        # two's-complement signed (common for CT, e.g. -1000 HU air) — a
        # plain uint view would wrap -1000 to 64536 and silently corrupt
        # the window/rescale. Reinterpret in place.
        if signed and px.dtype == np.uint16:
            px = px.view(np.int16)
        elif signed and px.dtype == np.uint8:
            px = px.view(np.int8)
    else:
        if TAG_PIXEL_DATA not in elements:
            raise DicomError("missing PixelData")
        raw = elements[TAG_PIXEL_DATA]
        dtype = {
            (8, False): np.uint8,
            (8, True): np.int8,
            (16, False): np.uint16,
            (16, True): np.int16,
        }[(bits, signed)]
        per_frame = rows * cols * samples
        need = per_frame * num_frames * dtype().itemsize
        if len(raw) < need:
            raise DicomError(
                f"PixelData has {len(raw)} bytes, header implies {need}"
            )
        px = np.frombuffer(
            raw, dtype=dtype, count=per_frame, offset=frame * per_frame * dtype().itemsize
        )
        px = px.reshape((rows, cols) if samples == 1 else (rows, cols, samples))

    if px.shape[:2] != (rows, cols):
        raise DicomError(
            f"decoded frame shape {px.shape} != header {rows}x{cols}"
        )

    return DicomImage(
        pixels=px,
        photometric=photometric,
        rescale_slope=_first_float(elements.get(TAG_RESCALE_SLOPE, b"1")) or 1.0,
        rescale_intercept=_first_float(elements.get(TAG_RESCALE_INTERCEPT, b"0"))
        or 0.0,
        window_center=_first_float(elements.get(TAG_WINDOW_CENTER, b"")),
        window_width=_first_float(elements.get(TAG_WINDOW_WIDTH, b"")),
        num_frames=num_frames,
    )


def _decode_encapsulated(
    fragments: List[bytes],
    ts: str,
    frame: int,
    num_frames: int,
    rows: int,
    cols: int,
    samples: int,
    bits: int,
) -> np.ndarray:
    if num_frames == 1:
        frag = b"".join(fragments)  # single frame may span fragments
    elif len(fragments) == num_frames:
        frag = fragments[frame]
    else:
        raise DicomError(
            f"{len(fragments)} fragments for {num_frames} frames — "
            "fragmented multi-frame without a usable offset table"
        )
    if ts == RLE_LOSSLESS:
        return _decode_rle_frame(frag, rows, cols, samples, bits)
    # JPEG decoders return unsigned stored values; DICOM signedness is
    # applied through RescaleIntercept in practice (CT offsets).
    return _decode_jpeg_frame(frag)


# ---------------------------------------------------------------------------
# Writer (tests/fixtures + synthetic streaming sources)
# ---------------------------------------------------------------------------


# Text VRs pad odd lengths with SPACE (PS3.5 §6.2); UI and binary VRs pad
# with NUL. The in-repo reader strips both, but externally-read fixtures
# should be conformant.
_TEXT_VRS = {b"AE", b"AS", b"CS", b"DA", b"DS", b"DT", b"IS", b"LO", b"LT",
             b"PN", b"SH", b"ST", b"TM", b"UC", b"UR", b"UT"}


def _element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b" " if vr in _TEXT_VRS else b"\x00"
    head = struct.pack("<HH", group, elem)
    if vr in _LONG_VRS:
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def _packbits_encode(data: bytes) -> bytes:
    """PackBits encode (for the RLE writer used by tests/fixtures)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find run length of identical bytes
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        run = j - i
        if run >= 3:
            out.append(257 - run)
            out.append(data[i])
            i = j
        else:
            # literal: until next run of >=3 or 128 bytes
            k = i
            while k < n and k - i < 128:
                if k + 2 < n and data[k] == data[k + 1] == data[k + 2]:
                    break
                k += 1
            out.append(k - i - 1)
            out += data[i:k]
            i = k
    return bytes(out)


def _encode_rle_frame(px: np.ndarray, bits: int) -> bytes:
    """px: (H, W) or (H, W, S) uint8/uint16 → DICOM RLE frame bytes."""
    samples = px.shape[2] if px.ndim == 3 else 1
    flat = px.reshape(-1, samples).T  # (S, H*W)
    segments: List[bytes] = []
    for s in range(samples):
        if bits == 8:
            segments.append(_packbits_encode(flat[s].astype(np.uint8).tobytes()))
        else:
            v = flat[s].astype(np.uint16)
            segments.append(_packbits_encode((v >> 8).astype(np.uint8).tobytes()))
            segments.append(_packbits_encode((v & 0xFF).astype(np.uint8).tobytes()))
    segments = [s + (b"\x00" if len(s) % 2 else b"") for s in segments]
    header = [len(segments)]
    off = 64
    for s in segments:
        header.append(off)
        off += len(s)
    header += [0] * (16 - len(header))
    return struct.pack("<16I", *header) + b"".join(segments)


def _encode_jpeg_frame(px: np.ndarray, ts: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    if ts in (JPEG2000_LOSSLESS, JPEG2000):
        img = Image.fromarray(px) if px.dtype != np.uint16 else Image.fromarray(
            px.astype(np.uint16)
        )
        img.save(buf, "JPEG2000")  # PIL default: reversible (lossless)
    else:
        if px.dtype != np.uint8:
            raise DicomError("JPEG baseline supports 8-bit only")
        Image.fromarray(px).save(buf, "JPEG", quality=95)
    return buf.getvalue()


def _encapsulate(frames: List[bytes]) -> bytes:
    """Undefined-length PixelData: empty BOT item + one item per frame."""
    body = struct.pack("<HHI", *_ITEM, 0)  # empty Basic Offset Table
    for f in frames:
        if len(f) % 2:
            f += b"\x00"
        body += struct.pack("<HHI", *_ITEM, len(f)) + f
    body += struct.pack("<HHI", *_SEQ_DELIM, 0)
    head = struct.pack("<HH", *TAG_PIXEL_DATA) + b"OB\x00\x00"
    return head + struct.pack("<I", _UNDEFINED) + body


def write_dicom(
    path: Union[str, Path, None],
    pixels: np.ndarray,
    photometric: Optional[str] = None,
    window: Optional[Tuple[float, float]] = None,
    rescale: Tuple[float, float] = (1.0, 0.0),
    transfer_syntax: str = EXPLICIT_VR_LE,
    multiframe: bool = False,
) -> bytes:
    """Serialize an array as a minimal Part-10 DICOM file.

    `multiframe=True` treats axis 0 of `pixels` as the frame axis.
    Compressed syntaxes (JPEG baseline, JPEG 2000, RLE) write encapsulated
    fragment sequences — used by tests and synthetic streaming sources.
    """
    pixels = np.asarray(pixels)
    frames = [pixels[i] for i in range(pixels.shape[0])] if multiframe else [pixels]
    f0 = frames[0]
    if f0.ndim == 3:
        samples, photometric = f0.shape[2], photometric or "RGB"
    else:
        samples, photometric = 1, photometric or "MONOCHROME2"
    bits = f0.dtype.itemsize * 8
    signed = np.issubdtype(f0.dtype, np.signedinteger)

    meta = _element(0x0002, 0x0010, b"UI", transfer_syntax.encode())
    body = b""
    body += _element(0x0028, 0x0002, b"US", struct.pack("<H", samples))
    body += _element(0x0028, 0x0004, b"CS", photometric.encode())
    if multiframe:
        body += _element(0x0028, 0x0008, b"IS", str(len(frames)).encode())
    body += _element(0x0028, 0x0010, b"US", struct.pack("<H", f0.shape[0]))
    body += _element(0x0028, 0x0011, b"US", struct.pack("<H", f0.shape[1]))
    body += _element(0x0028, 0x0100, b"US", struct.pack("<H", bits))
    body += _element(0x0028, 0x0103, b"US", struct.pack("<H", 1 if signed else 0))
    if window is not None:
        body += _element(0x0028, 0x1050, b"DS", str(window[0]).encode())
        body += _element(0x0028, 0x1051, b"DS", str(window[1]).encode())
    body += _element(0x0028, 0x1052, b"DS", str(rescale[1]).encode())
    body += _element(0x0028, 0x1053, b"DS", str(rescale[0]).encode())

    if transfer_syntax in ENCAPSULATED_SYNTAXES:
        if transfer_syntax == RLE_LOSSLESS:
            blobs = [_encode_rle_frame(f, bits) for f in frames]
        else:
            blobs = [_encode_jpeg_frame(f, transfer_syntax) for f in frames]
        body += _encapsulate(blobs)
    elif transfer_syntax in (EXPLICIT_VR_LE, DEFLATED_EXPLICIT_VR_LE):
        vr = b"OB" if bits == 8 else b"OW"
        body += _element(0x7FE0, 0x0010, vr, b"".join(f.tobytes() for f in frames))
    else:
        raise DicomError(f"writer does not support {transfer_syntax!r}")

    if transfer_syntax == DEFLATED_EXPLICIT_VR_LE:
        co = zlib.compressobj(wbits=-15)
        body = co.compress(body) + co.flush()

    blob = b"\x00" * 128 + b"DICM" + meta + body
    if path is not None:
        Path(path).write_bytes(blob)
    return blob
