"""EXIF parsing from raw APP1 payload bytes (reference: libs/mve/image_exif.h).

Standalone TIFF/IFD walker (no external library, like the reference's
491-line parser): extracts the fields MVE consumes — camera maker/model,
focal length, 35mm-equivalent focal length, ISO, exposure, aperture,
image size and orientation (image_exif.h:31-117 ExifInfo struct).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional


@dataclasses.dataclass
class ExifInfo:
    camera_maker: str = ""
    camera_model: str = ""
    description: str = ""
    date_original: str = ""
    date_modified: str = ""
    focal_length: float = -1.0
    focal_length_35mm: float = -1.0
    f_number: float = -1.0
    exposure_time: float = -1.0
    iso_speed: int = -1
    shutter_speed: float = -1.0
    flash_mode: int = -1
    image_width: int = -1
    image_height: int = -1
    orientation: int = -1


_TAGS_IFD0 = {
    0x010F: "camera_maker",
    0x0110: "camera_model",
    0x010E: "description",
    0x0132: "date_modified",
    0x0112: "orientation",
}
_TAGS_SUB = {
    0x920A: "focal_length",
    0xA405: "focal_length_35mm",
    0x829D: "f_number",
    0x829A: "exposure_time",
    0x8827: "iso_speed",
    0x9201: "shutter_speed",
    0x9209: "flash_mode",
    0xA002: "image_width",
    0xA003: "image_height",
    0x9003: "date_original",
}


def exif_extract(data: bytes) -> Optional[ExifInfo]:
    """Parse a raw EXIF blob (with or without the "Exif\\0\\0" prefix)."""
    if data[:6] == b"Exif\x00\x00":
        data = data[6:]
    if len(data) < 8:
        return None
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        return None
    (magic,) = struct.unpack_from(endian + "H", data, 2)
    if magic != 42:
        return None
    (ifd0_off,) = struct.unpack_from(endian + "I", data, 4)

    info = ExifInfo()

    def read_value(fmt_type, count, value_off):
        type_size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8}.get(fmt_type)
        if type_size is None:
            return None
        total = type_size * count
        if total <= 4:
            off = value_off
        else:
            (off,) = struct.unpack_from(endian + "I", data, value_off)
        if off + total > len(data):
            return None
        if fmt_type == 2:  # ASCII
            raw = data[off : off + count]
            return raw.split(b"\x00")[0].decode("ascii", "replace").strip()
        if fmt_type == 3:
            return struct.unpack_from(endian + "H", data, off)[0]
        if fmt_type in (4, 9):
            return struct.unpack_from(endian + ("i" if fmt_type == 9 else "I"), data, off)[0]
        if fmt_type in (5, 10):
            num, den = struct.unpack_from(endian + ("ii" if fmt_type == 10 else "II"), data, off)
            return num / den if den else 0.0
        if fmt_type == 1:
            return data[off]
        return None

    def walk_ifd(offset, tag_map):
        sub_ifd_off = None
        if offset + 2 > len(data):
            return None
        (count,) = struct.unpack_from(endian + "H", data, offset)
        for i in range(count):
            entry = offset + 2 + i * 12
            if entry + 12 > len(data):
                break
            tag, ftype, n = struct.unpack_from(endian + "HHI", data, entry)
            if tag == 0x8769:  # EXIF sub-IFD pointer
                (sub_ifd_off,) = struct.unpack_from(endian + "I", data, entry + 8)
                continue
            name = tag_map.get(tag)
            if name is None:
                continue
            val = read_value(ftype, n, entry + 8)
            if val is not None:
                setattr(info, name, val)
        return sub_ifd_off

    sub = walk_ifd(ifd0_off, _TAGS_IFD0)
    if sub is not None:
        walk_ifd(sub, _TAGS_SUB)
    return info
