"""Context-image augmentation (host-side NumPy, NHWC; the port's copy of
data/augmentation.py, with the same draws, through data/streams.py: by
default the global `random` and `np.random`):
  - RandomBackground: with the robot mask, substitute the background with a
    random solid colour / two-colour gradient / +-noise image, and
    optionally paste a random occluder crop (from a COCO-format directory,
    or any directory of cutout images);
  - ZeroMaskPatchedImage: zero a random fraction of patch_size x patch_size
    tiles;
  - flip transforms that keep a pixel map consistent.
Images are read and resized through data/image_io.py.
"""

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import image_io
from .streams import nprandom, pyrandom


def _rgb(img: np.ndarray) -> np.ndarray:
    """A decoded image as uint8 RGB [H, W, 3] (PIL's convert("RGB") for
    grayscale, grayscale+alpha and RGBA pixels)."""
    if img.dtype != np.uint8:
        raise ValueError(f"cannot convert a {img.dtype} image to RGB")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _crop(img: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """PIL's Image.crop: the box [x0, x1) x [y0, y1), zero outside the image."""
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0), img.shape[2]), img.dtype)
    h, w = img.shape[:2]
    ys, xs = slice(max(y0, 0), min(y1, h)), slice(max(x0, 0), min(x1, w))
    if ys.start < ys.stop and xs.start < xs.stop:
        out[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = img[ys, xs]
    return out


def get_random_solid_color_image(shape) -> np.ndarray:
    """image_augmentation.py:240-243 (uint8, [H, W, 3])."""
    rgb = (nprandom().rand(3) * 255).astype(np.uint8)
    return np.ones(shape, np.uint8) * rgb[None, None, :]


def get_gradient_image(rgb1: np.ndarray, rgb2: np.ndarray, vertical: bool) -> np.ndarray:
    """image_augmentation.py:246-265."""
    h, w = rgb1.shape[:2]
    if vertical:
        alpha = np.tile(np.linspace(0, 1, h)[:, None], (1, w))
    else:
        alpha = np.tile(np.linspace(0, 1, w), (h, 1))
    return (rgb2 * alpha[..., None] + rgb1 * (1.0 - alpha[..., None]))


def add_noise(rgb_image: np.ndarray, max_noise: int = 50) -> np.ndarray:
    """image_augmentation.py:268-285 (uint8 wraparound preserved)."""
    shape = rgb_image.shape
    noise_a = (nprandom().rand(*shape) * max_noise).astype(np.uint8)
    noise_b = (nprandom().rand(*shape) * max_noise).astype(np.uint8)
    return (rgb_image.astype(np.uint8) + noise_a - noise_b).astype(np.uint8)


def get_random_image(shape) -> np.ndarray:
    """Random solid / gradient background, optionally noised
    (image_augmentation.py:226-237). shape = (H, W, 3); returns uint8."""
    if nprandom().rand() < 0.5:
        img = get_random_solid_color_image(shape)
    else:
        img = get_gradient_image(
            get_random_solid_color_image(shape),
            get_random_solid_color_image(shape),
            vertical=bool(nprandom().rand() < 0.5),
        )
    if nprandom().rand() < 0.5:
        return img.astype(np.uint8)
    return add_noise(img)


class ZeroMaskPatchedImage:
    """Zero a random mask_ratio of tiles (image_augmentation.py:55-82).
    Operates on [H, W, C] float images; H, W must divide by patch_size."""

    def __init__(self, patch_size: int = 20, mask_ratio: float = 0.5):
        self.patch_size = patch_size
        self.mask_ratio = mask_ratio

    def __call__(self, image: np.ndarray) -> np.ndarray:
        p = self.patch_size
        h, w = image.shape[:2]
        l, k = h // p, w // p
        out = image.copy()
        tiles = out[: l * p, : k * p].reshape(l, p, k, p, -1).swapaxes(1, 2)
        flat = tiles.reshape(l * k, p, p, -1)
        idx = nprandom().permutation(l * k)[: int(l * k * self.mask_ratio)]
        flat[idx] = 0.0
        out[: l * p, : k * p] = flat.reshape(l, k, p, p, -1).swapaxes(1, 2).reshape(
            l * p, k * p, -1
        )
        return out


class CocoOccluderSource:
    """COCO-instance occluder crops, no pycocotools needed.

    The reference builds occluders from COCO2017 bbox crops with area
    thresholds (image_augmentation.py:96-100, 146-190 — it only reads
    `file_name`, `bbox`, `area`, `iscrowd` from the annotation file, never
    the segmentation masks), so a plain json parse reproduces it exactly.

    root must hold annotations/instances_<split>.json and <split>/<images>.
    """

    def __init__(self, root, split: str = "train2017",
                 min_area_threshold: float = 10000,
                 max_area_threshold: float = 50000):
        import json

        self.root = Path(root)
        self.split = split
        self.min_area = min_area_threshold
        self.max_area = max_area_threshold
        with open(self.root / "annotations" / f"instances_{split}.json",
                  encoding="utf-8") as f:
            data = json.load(f)
        self.filenames = {im["id"]: im["file_name"] for im in data["images"]}
        self.anns_by_image = {}
        for a in data.get("annotations", []):
            if a.get("iscrowd"):
                continue
            self.anns_by_image.setdefault(a["image_id"], []).append(
                (tuple(a["bbox"]), float(a["area"])))
        self.image_ids = list(self.filenames)

    def sample(self) -> Optional[np.ndarray]:
        """One bbox-cropped instance as float [h, w, 3] in [0, 1], or None
        (empty image / area below threshold — the reference returns the
        input unchanged in those cases)."""
        img_id = pyrandom().choice(self.image_ids)
        anns = self.anns_by_image.get(img_id, [])
        if not anns:
            return None
        bbox, area = anns[nprandom().randint(0, len(anns))]
        if area < self.min_area:
            return None
        x_min, y_min, bw, bh = bbox
        img = _rgb(image_io.read_image(self.root / self.split / self.filenames[img_id]))
        crop = _crop(img, int(x_min), int(y_min), int(x_min + bw), int(y_min + bh))
        if area > self.max_area:
            # reference parity (image_augmentation.py:166-176): both axes
            # scale LINEARLY by rand_threshold/area, so the resulting area is
            # rand_threshold^2/area — quadratically smaller than the sampled
            # threshold. That quirk is the reference's own and is kept —
            # EXCEPT the max(1, ...) clamps below, which diverge from the
            # reference only where rand_threshold*dim/area < 1, a degenerate
            # case where PIL would raise on a 0-size resize.
            rand_threshold = nprandom().randint(int(self.min_area), int(self.max_area))
            crop = image_io.resize_bilinear(crop, max(1, int(bw * rand_threshold / area)),
                                            max(1, int(bh * rand_threshold / area)))
        return np.asarray(crop).astype(np.float32) / 255.0


class RandomBackground:
    """Background substitution + occluder paste (image_augmentation.py:85-221).

    Occluder sources, in priority order: `coco_root` (COCO2017-format dir —
    full reference parity via CocoOccluderSource) or `occluder_dir` (any
    directory of RGB cutout images — the zero-egress stand-in). None
    disables the paste branch.
    """

    def __init__(self, p: float = 0.5, occluder_dir: Optional[Path] = None,
                 overlay_threshold: float = 0.5, coco_root: Optional[Path] = None):
        self.p = p
        self.overlay_threshold = overlay_threshold
        self.coco: Optional[CocoOccluderSource] = None
        if coco_root is not None:
            if Path(coco_root).exists():
                self.coco = CocoOccluderSource(coco_root)
            else:
                # loud, not fatal: an unmounted volume shouldn't kill a long
                # run, but silently training without the requested occluder
                # augmentation would be worse
                print(f"WARNING: coco_root={coco_root} does not exist — "
                      "occluder augmentation falls back to "
                      f"{'occluder_dir' if occluder_dir else 'DISABLED'}",
                      flush=True)
        self.occluders: List[Path] = []
        if occluder_dir is not None:
            self.occluders = sorted(
                q for q in Path(occluder_dir).glob("*")
                if q.suffix.lower() in (".png", ".jpg", ".jpeg")
            )

    def randomize_bkgd(self, img: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """img [H, W, 3] float[0,1]; mask [H, W] bool/float (1 = robot)."""
        m = mask[..., None].astype(img.dtype)
        background = get_random_image(img.shape).astype(np.float32) / 255.0
        return img * m + background * (1.0 - m)

    def randomize_occluder(self, img: np.ndarray, mask: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        if self.coco is not None:
            crop = self.coco.sample()
            if crop is None:
                return img
        elif self.occluders:
            crop = _rgb(image_io.read_image(pyrandom().choice(self.occluders))
                        ).astype(np.float32) / 255.0
        else:
            return img
        # shrink until it fits
        while crop.shape[0] >= h or crop.shape[1] >= w:
            crop = crop[::2, ::2]
        ch, cw = crop.shape[:2]
        if ch < 2 or cw < 2:
            return img
        y = nprandom().randint(0, h - ch)
        x = nprandom().randint(0, w - cw)
        # refuse if the paste would hide too much of the robot
        # (image_augmentation.py:195-209)
        area_before = float(np.sum(mask))
        new_mask = mask.copy()
        new_mask[y : y + ch, x : x + cw] = 0
        if float(np.sum(new_mask)) < area_before * self.overlay_threshold:
            return img
        out = img.copy()
        out[y : y + ch, x : x + cw] = crop
        return out

    def __call__(self, img: np.ndarray, mask: np.ndarray) -> np.ndarray:
        if nprandom().rand() < self.p:
            img = self.randomize_bkgd(img, mask)
        if nprandom().rand() < self.p:
            img = self.randomize_occluder(img, mask)
        return img


def random_horizontal_flip(images: List[np.ndarray], pix_map: np.ndarray,
                           p: float = 0.5) -> Tuple[List[np.ndarray], np.ndarray]:
    """image_augmentation.py:15-32 ([H, W, C] images, pix_map [..., H, W, 2])."""
    if nprandom().rand() < p:
        w = images[0].shape[1]
        images = [img[:, ::-1] for img in images]
        pix_map = pix_map.copy()
        pix_map[..., 0] = (w - 1) - pix_map[..., 0]
    return images, pix_map


def random_vertical_flip(images: List[np.ndarray], pix_map: np.ndarray,
                         p: float = 0.5) -> Tuple[List[np.ndarray], np.ndarray]:
    """image_augmentation.py:35-52."""
    if nprandom().rand() < p:
        h = images[0].shape[0]
        images = [img[::-1] for img in images]
        pix_map = pix_map.copy()
        pix_map[..., 1] = (h - 1) - pix_map[..., 1]
    return images, pix_map
