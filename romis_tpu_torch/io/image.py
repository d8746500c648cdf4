"""Image output: BMP and PNG with the standard library and numpy only
(reference ``romis_tpu/io/image.py``): clamp to [0, 1], quantise to u8."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(image: np.ndarray) -> np.ndarray:
    """Clamp float RGB [H, W, 3] to [0, 1] and quantise to uint8."""
    img = np.asarray(image, np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_bmp(path: str, image: np.ndarray) -> None:
    """A 24-bit BMP of float or u8 RGB [H, W, 3], row 0 = top."""
    img = to_u8(image) if image.dtype != np.uint8 else image
    h, w, _ = img.shape
    row_pad = (-(w * 3)) % 4
    pixel_bytes = (w * 3 + row_pad) * h
    bgr = img[::-1, :, ::-1]  # BMP stores rows bottom-up, BGR
    pad = b"\x00" * row_pad
    rows = b"".join(bgr[r].tobytes() + pad for r in range(h))
    header = struct.pack(
        "<2sIHHI", b"BM", 14 + 40 + pixel_bytes, 0, 0, 14 + 40
    ) + struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, pixel_bytes, 2835, 2835, 0, 0
    )
    with open(path, "wb") as f:
        f.write(header + rows)


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit RGB PNG, compressed with zlib."""
    img = to_u8(image) if image.dtype != np.uint8 else image
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_image(path: str, image: np.ndarray) -> None:
    """BMP, .npy or (otherwise) PNG, by the path's extension."""
    if str(path).lower().endswith(".bmp"):
        write_bmp(path, image)
    elif str(path).lower().endswith(".npy"):
        np.save(path, np.asarray(image, np.float32))
    else:
        write_png(path, image)
