"""Focal length estimation from EXIF (reference:
libs/sfm/extract_focal_length.h:36-55, camera_database.cc).

Priority: (1) 35mm-equivalent focal length from EXIF; (2) focal length in
mm plus sensor width from a maker/model database; (3) fallback 1.0
(a common default for compact cameras). The returned value is the focal
length normalized by the larger image dimension (35mm frame: 36mm wide).
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

from ..core.image_exif import ExifInfo


class FocalLengthMethod(enum.Enum):
    FROM_EXIF_35MM = 0
    FROM_EXIF_DB = 1
    FALLBACK = 2


# Sensor widths in mm, keyed on (maker substring, model substring),
# lower-case. Public spec-sheet facts for common camera families — the
# reference ships a much larger hardcoded list (camera_database.cc:680
# lines); extend as needed.
SENSOR_WIDTH_DB = [
    # Canon: full-frame bodies, APS-C DSLR/mirrorless, compacts.
    ("canon", "eos 5d", 36.0),
    ("canon", "eos 6d", 35.8),
    ("canon", "eos 1d x", 36.0),
    ("canon", "eos-1d", 27.9),
    ("canon", "eos r5", 36.0),
    ("canon", "eos r6", 36.0),
    ("canon", "eos r", 36.0),
    ("canon", "eos 7d", 22.3),
    ("canon", "eos 10d", 22.7),
    ("canon", "eos 20d", 22.5),
    ("canon", "eos 30d", 22.5),
    ("canon", "eos 40d", 22.2),
    ("canon", "eos 50d", 22.3),
    ("canon", "eos 60d", 22.3),
    ("canon", "eos 70d", 22.5),
    ("canon", "eos 80d", 22.3),
    ("canon", "eos 300d", 22.7),
    ("canon", "eos 350d", 22.2),
    ("canon", "eos 400d", 22.2),
    ("canon", "eos 450d", 22.2),
    ("canon", "eos 1000d", 22.2),
    ("canon", "rebel", 22.2),
    ("canon", "kiss", 22.2),
    ("canon", "eos m", 22.3),
    ("canon", "eos", 22.3),        # remaining EOS bodies: APS-C
    ("canon", "powershot g", 7.44),
    ("canon", "powershot s1", 5.76),
    ("canon", "powershot sx", 6.17),
    ("canon", "powershot", 5.76),
    ("canon", "ixus", 6.17),
    ("canon", "digital ixus", 5.76),
    # Nikon: FX bodies, DX bodies, 1-series, compacts.
    ("nikon", "d3x", 35.9),
    ("nikon", "d3s", 36.0),
    ("nikon", "d3", 36.0),
    ("nikon", "d4", 36.0),
    ("nikon", "d5 ", 36.0),
    ("nikon", "d6", 35.9),
    ("nikon", "d600", 35.9),
    ("nikon", "d610", 35.9),
    ("nikon", "d700", 36.0),
    ("nikon", "d750", 35.9),
    ("nikon", "d780", 35.9),
    ("nikon", "d800", 35.9),
    ("nikon", "d810", 35.9),
    ("nikon", "d850", 35.9),
    ("nikon", "df", 36.0),
    ("nikon", "z 5", 35.9),
    ("nikon", "z 6", 35.9),
    ("nikon", "z 7", 35.9),
    ("nikon", "z 9", 35.9),
    ("nikon", "z 50", 23.5),
    ("nikon", "d40", 23.7),
    ("nikon", "d50", 23.7),
    ("nikon", "d60", 23.6),
    ("nikon", "d70", 23.7),
    ("nikon", "d80", 23.6),
    ("nikon", "d90", 23.6),
    ("nikon", "d1", 23.7),
    ("nikon", "d2", 23.7),
    ("nikon", "d5000", 23.6),
    ("nikon", "d7000", 23.6),
    ("nikon", "d300", 23.6),
    ("nikon", "d", 23.6),          # remaining D bodies: DX
    ("nikon", "1 ", 13.2),
    ("nikon", "coolpix p", 6.16),
    ("nikon", "coolpix", 6.16),
    # Sony: full-frame Alpha/RX1, APS-C, RX100 line, compacts.
    ("sony", "ilce-7", 35.8),
    ("sony", "ilce-9", 35.6),
    ("sony", "ilce-1", 35.9),
    ("sony", "ilce", 23.5),
    ("sony", "nex", 23.5),
    ("sony", "slt-a99", 35.8),
    ("sony", "slt", 23.5),
    ("sony", "dslr-a850", 35.9),
    ("sony", "dslr-a900", 35.9),
    ("sony", "dslr", 23.5),
    ("sony", "dsc-rx1", 35.8),
    ("sony", "dsc-rx100", 13.2),
    ("sony", "dsc-rx10", 13.2),
    ("sony", "dsc-h", 6.16),
    ("sony", "dsc-w", 6.16),
    ("sony", "dsc", 6.16),
    # Fujifilm: X-series APS-C, X10/X20 2/3", FinePix compacts.
    ("fujifilm", "x-t", 23.6),
    ("fujifilm", "x-e", 23.6),
    ("fujifilm", "x-pro", 23.6),
    ("fujifilm", "x-s", 23.5),
    ("fujifilm", "x100", 23.6),
    ("fujifilm", "x1", 8.8),
    ("fujifilm", "x2", 8.8),
    ("fujifilm", "gfx", 43.8),
    ("fujifilm", "finepix s", 6.4),
    ("fujifilm", "finepix", 6.4),
    # Micro Four Thirds (Olympus, OM System, Panasonic G-series).
    ("olympus", "e-m", 17.3),
    ("olympus", "pen", 17.3),
    ("olympus", "e-", 17.3),
    ("olympus", "stylus", 6.16),
    ("olympus", "tg-", 6.16),
    ("om digital", "om-", 17.3),
    ("panasonic", "dmc-gh", 17.3),
    ("panasonic", "dmc-g", 17.3),
    ("panasonic", "dc-g", 17.3),
    ("panasonic", "dmc-lx100", 17.3),
    ("panasonic", "dmc-lx", 7.44),
    ("panasonic", "dmc-fz1000", 13.2),
    ("panasonic", "dmc-fz", 6.08),
    ("panasonic", "dmc-tz", 6.08),
    ("panasonic", "dmc", 6.08),
    ("leica", "m", 35.8),
    ("leica", "q", 36.0),
    ("leica", "sl", 36.0),
    ("leica", "", 17.3),
    ("pentax", "k-1", 35.9),
    ("pentax", "645", 43.8),
    ("pentax", "k", 23.5),
    ("pentax", "optio", 6.16),
    ("ricoh", "gr", 23.7),
    ("sigma", "dp", 20.7),
    # Phones and action cams (device families; 1/2.3"-1/1.3" classes).
    ("apple", "iphone 1", 7.6),
    ("apple", "iphone", 4.89),
    ("samsung", "sm-s2", 7.3),
    ("samsung", "sm-g", 6.4),
    ("samsung", "sm-", 5.76),
    ("samsung", "galaxy", 5.76),
    ("samsung", "", 6.08),        # Samsung compacts
    ("google", "pixel 6", 8.2),
    ("google", "pixel 7", 8.2),
    ("google", "pixel 8", 8.2),
    ("google", "pixel", 6.17),
    ("lg", "nexus", 4.54),
    ("huawei", "", 6.4),
    ("xiaomi", "", 6.44),
    ("oneplus", "", 6.4),
    ("gopro", "", 6.17),
    ("dji", "", 6.4),
    ("kodak", "", 6.16),
    ("casio", "", 6.16),
    ("hewlett-packard", "", 5.76),
    ("hp", "", 5.76),
]


def lookup_sensor_width(maker: str, model: str) -> Optional[float]:
    """Exact maker/model lookup first (the reference's 554-entry
    camera_database.cc), then the family-substring fallback above."""
    from .camera_database import lookup

    exact = lookup(maker, model)
    if exact is not None:
        return exact.sensor_width_mm
    maker_l = maker.lower()
    model_l = model.lower()
    for m, mod, width in SENSOR_WIDTH_DB:
        if m in maker_l and mod in model_l:
            return width
    return None


def extract_focal_length(exif: Optional[ExifInfo]) -> Tuple[float, FocalLengthMethod]:
    """Returns (normalized_focal_length, method)."""
    if exif is not None:
        if exif.focal_length_35mm > 0:
            return exif.focal_length_35mm / 36.0, FocalLengthMethod.FROM_EXIF_35MM
        if exif.focal_length > 0:
            width = lookup_sensor_width(exif.camera_maker, exif.camera_model)
            if width is not None:
                return exif.focal_length / width, FocalLengthMethod.FROM_EXIF_DB
    return 1.0, FocalLengthMethod.FALLBACK
