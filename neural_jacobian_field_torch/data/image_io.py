"""Image files of the data pipeline, through Pillow: RGB PNGs (8-bit) and
depth PNGs (16-bit grayscale, millimetres) read and written in one place.
The native batch decoder (data/native.py), which the loader calls itself,
is the other reader. `DECODED` counts the files each path read ("pillow",
"native"), so a caller can say which served.
"""

import collections
from pathlib import Path

import numpy as np

DECODED = collections.Counter()  # path ("pillow", "native") -> files


def read_image(path) -> np.ndarray:
    """An image file's pixels as stored (np.asarray(PIL.Image.open(path)),
    palettes expanded to RGB or RGBA)."""
    from PIL import Image

    with Image.open(Path(path)) as img:
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info else "RGB")
        out = np.asarray(img)
    DECODED["pillow"] += 1
    return out


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's bilinear resize of a uint8 image."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))


def write_rgb(path, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] -> an 8-bit RGB PNG."""
    _write(path, np.asarray(rgb, np.uint8))


def write_depth(path, depth: np.ndarray) -> None:
    """uint16 [H, W] -> a 16-bit grayscale PNG."""
    _write(path, np.asarray(depth, np.uint16))


def _write(path, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)
