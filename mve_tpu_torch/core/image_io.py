"""Image I/O: PNG/JPEG/TIFF/PFM/PPM and the native MVEI format.

Reference: libs/mve/image_io.cc. The MVEI binary layout is kept
byte-compatible so scene embeddings interoperate with the reference:
11-byte signature ``\\x89MVE_IMAGE\\n`` followed by four little-endian
int32 (width, height, channels, type enum) and raw row-major
channel-interleaved pixel data (image_io.cc:44-46, save_mvei_file).

Images are numpy arrays of shape (H, W, C); C is always explicit.
PNG/JPEG/TIFF are handled through PIL instead of libpng/libjpeg/libtiff.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MVEI_SIGNATURE = b"\x89MVE_IMAGE\n"

# Type enum values match mve::ImageType (libs/mve/image_base.h:29-42).
_TYPE_TO_DTYPE = {
    1: np.uint8,
    2: np.uint16,
    3: np.uint32,
    4: np.uint64,
    5: np.int8,
    6: np.int16,
    7: np.int32,
    8: np.int64,
    9: np.float32,
    10: np.float64,
}
_DTYPE_TO_TYPE = {np.dtype(v): k for k, v in _TYPE_TO_DTYPE.items()}


def _as_hwc(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected 2D/3D image, got shape {arr.shape}")
    return np.ascontiguousarray(arr)


# ---------------------------------------------------------------------------
# MVEI
# ---------------------------------------------------------------------------

def save_mvei(image: np.ndarray, path: str) -> None:
    image = _as_hwc(image)
    dtype = np.dtype(image.dtype)
    if dtype not in _DTYPE_TO_TYPE:
        raise ValueError(f"unsupported dtype for MVEI: {dtype}")
    h, w, c = image.shape
    with open(path, "wb") as f:
        f.write(MVEI_SIGNATURE)
        f.write(struct.pack("<iiii", w, h, c, _DTYPE_TO_TYPE[dtype]))
        f.write(image.tobytes())


def load_mvei(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        sig = f.read(len(MVEI_SIGNATURE))
        if sig != MVEI_SIGNATURE:
            raise IOError(f"{path}: invalid MVEI signature")
        w, h, c, t = struct.unpack("<iiii", f.read(16))
        if t not in _TYPE_TO_DTYPE:
            raise IOError(f"{path}: unknown MVEI type {t}")
        dtype = np.dtype(_TYPE_TO_DTYPE[t])
        data = f.read(w * h * c * dtype.itemsize)
    arr = np.frombuffer(data, dtype=dtype)
    if arr.size != w * h * c:
        raise IOError(f"{path}: truncated MVEI data")
    return arr.reshape(h, w, c).copy()


def load_mvei_headers(path: str):
    """Return (width, height, channels, dtype) without reading pixel data
    (image_io.cc load_mvei_file_headers)."""
    with open(path, "rb") as f:
        sig = f.read(len(MVEI_SIGNATURE))
        if sig != MVEI_SIGNATURE:
            raise IOError(f"{path}: invalid MVEI signature")
        w, h, c, t = struct.unpack("<iiii", f.read(16))
    return w, h, c, np.dtype(_TYPE_TO_DTYPE[t])


# ---------------------------------------------------------------------------
# PFM (portable float map, image_io.cc:1085-1190)
# ---------------------------------------------------------------------------

def save_pfm(image: np.ndarray, path: str) -> None:
    image = _as_hwc(image).astype(np.float32)
    h, w, c = image.shape
    if c not in (1, 3):
        raise ValueError("PFM supports 1 or 3 channels")
    header = b"Pf\n" if c == 1 else b"PF\n"
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{w} {h}\n".encode())
        # Negative scale => little-endian; rows bottom-to-top per spec.
        f.write(b"-1.0\n")
        f.write(image[::-1].tobytes())


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic == b"Pf":
            c = 1
        elif magic == b"PF":
            c = 3
        else:
            raise IOError(f"{path}: PFM signature did not match")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * c * 4), dtype=dtype)
    return data.reshape(h, w, c)[::-1].astype(np.float32).copy()


# ---------------------------------------------------------------------------
# PPM/PGM (binary P5/P6, 8- and 16-bit, image_io.cc:975-1080)
# ---------------------------------------------------------------------------

def save_ppm(image: np.ndarray, path: str) -> None:
    image = _as_hwc(image)
    h, w, c = image.shape
    if c == 1:
        magic = b"P5"
    elif c == 3:
        magic = b"P6"
    else:
        raise ValueError("PPM supports 1 or 3 channels")
    if image.dtype == np.uint8:
        maxval = 255
        data = image.tobytes()
    elif image.dtype == np.uint16:
        maxval = 65535
        data = image.astype(">u2").tobytes()
    else:
        raise ValueError("PPM supports uint8/uint16")
    with open(path, "wb") as f:
        f.write(magic + b"\n")
        f.write(f"{w} {h}\n{maxval}\n".encode())
        f.write(data)


def load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        content = f.read()
    # Parse header tokens, skipping comments.
    tokens = []
    i = 0
    while len(tokens) < 4:
        if content[i : i + 1] == b"#":
            while content[i : i + 1] not in (b"\n", b""):
                i += 1
        elif content[i : i + 1].isspace():
            i += 1
        else:
            j = i
            while not content[j : j + 1].isspace():
                j += 1
            tokens.append(content[i:j])
            i = j
    i += 1  # single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        c = 1
    elif magic == b"P6":
        c = 3
    else:
        raise IOError(f"{path}: PPM signature did not match")
    if maxval <= 255:
        arr = np.frombuffer(content, dtype=np.uint8, count=w * h * c, offset=i)
    else:
        arr = np.frombuffer(content[i:], dtype=">u2", count=w * h * c).astype(np.uint16)
    return arr.reshape(h, w, c).copy()


# ---------------------------------------------------------------------------
# PNG / JPEG / TIFF via PIL
# ---------------------------------------------------------------------------

def _load_pil(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info else "RGB")
        arr = np.asarray(img)
    return _as_hwc(arr)


def _save_pil(image: np.ndarray, path: str, quality: int = 90) -> None:
    from PIL import Image

    image = _as_hwc(image)
    if image.shape[2] == 1:
        image = image[:, :, 0]
    pil = Image.fromarray(image)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        if pil.mode == "RGBA":
            pil = pil.convert("RGB")
        pil.save(path, quality=quality)
    else:
        pil.save(path)


def load_jpeg_exif(path: str) -> bytes:
    """Extract the raw EXIF blob (APP1 payload) from a JPEG file.

    Mirrors the reference's behavior of handing the raw EXIF bytes to the
    parser (image_io.cc load_jpg_file exif out-param). Returns b"" if absent.
    """
    with open(path, "rb") as f:
        data = f.read(131072)
    i = 2  # skip SOI
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            break
        marker = data[i + 1]
        if marker in (0xD8, 0xD9):
            i += 2
            continue
        seglen = struct.unpack(">H", data[i + 2 : i + 4])[0]
        if marker == 0xE1 and data[i + 4 : i + 10] == b"Exif\x00\x00":
            return data[i + 4 : i + 2 + seglen]
        i += 2 + seglen
    return b""


# ---------------------------------------------------------------------------
# Dispatch (image_io.cc load_file/save_file by extension + magic probing)
# ---------------------------------------------------------------------------

_LOADERS = {
    ".mvei": load_mvei,
    ".pfm": load_pfm,
    ".ppm": load_ppm,
    ".pgm": load_ppm,
}
_SAVERS = {
    ".mvei": save_mvei,
    ".pfm": save_pfm,
    ".ppm": save_ppm,
    ".pgm": save_ppm,
}
_PIL_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def load_image(path: str) -> np.ndarray:
    """Load any supported image as (H, W, C) numpy array."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _LOADERS:
        return _LOADERS[ext](path)
    if ext in _PIL_EXTS:
        return _load_pil(path)
    # Fall back to magic probing like the reference dispatcher.
    with open(path, "rb") as f:
        head = f.read(12)
    if head.startswith(MVEI_SIGNATURE):
        return load_mvei(path)
    if head.startswith(b"Pf") or head.startswith(b"PF"):
        return load_pfm(path)
    if head.startswith(b"P5") or head.startswith(b"P6"):
        return load_ppm(path)
    return _load_pil(path)


def save_image(image: np.ndarray, path: str, **kw) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in _SAVERS:
        _SAVERS[ext](image, path)
    elif ext in _PIL_EXTS:
        _save_pil(image, path, **kw)
    else:
        raise ValueError(f"unsupported image extension: {ext}")
