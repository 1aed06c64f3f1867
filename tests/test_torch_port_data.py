"""The port's host data pipeline against the JAX package's: synthetic
scenes written by both decode to equal arrays, transforms.json equal once
parsed, the dataparser's outputs equal; dataset items equal under the same
seeds of `random` and `np.random`, in perception, flow and tracks modes,
whichever path decodes the images (the native batch decoder, Pillow);
DataLoader batches (num_workers=0) equal to JAX's; collate's track
padding; the augmentation's occluder sources on fabricated images;
image_io's reads, writes and resizes against Pillow's own; the device
prefetcher on the CPU. Exact equality throughout (the images are 8- and
16-bit integers; float32 values come from the same operations on both
sides)."""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.data import image_io
from neural_jacobian_field_torch.data import native as tnative

SCENE = dict(num_cameras=3, num_trajs=2, frames_per_traj=3, height=16, width=24, action_dim=4)


@pytest.fixture
def no_native(monkeypatch):
    """The port's native decoder unavailable (the per-item path serves)."""
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from neural_jacobian_field_tpu.data.synthetic import make_synthetic_scene as jscene
    from neural_jacobian_field_torch.data import make_synthetic_scene

    root = tmp_path_factory.mktemp("scenes")
    jscene(root / "jax", **SCENE)
    make_synthetic_scene(root / "port", **SCENE)
    return root


def _files(root: Path, suffix: str):
    return sorted(p.relative_to(root) for p in root.rglob(f"*{suffix}"))


def test_synthetic_scene_matches_jax(scenes):
    from PIL import Image

    jroot, troot = scenes / "jax", scenes / "port"
    assert (json.loads((troot / "transforms.json").read_text())
            == json.loads((jroot / "transforms.json").read_text()))
    pngs = _files(jroot, ".png")
    assert pngs == _files(troot, ".png") and len(pngs) == 2 * 3 * 2 * 3
    for rel in pngs:
        want = np.asarray(Image.open(jroot / rel))
        got = image_io.read_image(troot / rel)
        assert got.dtype == want.dtype and np.array_equal(got, want), rel
    npzs = _files(jroot, ".npz")
    assert npzs == _files(troot, ".npz") and npzs
    for rel in npzs:
        a, b = np.load(jroot / rel), np.load(troot / rel)
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a), rel


def test_dataparser_matches_jax(scenes):
    from neural_jacobian_field_tpu.data import dataparser as jdp
    from neural_jacobian_field_torch.data import dataparser as tdp

    for method in ("up", "pca", "vertical", "none"):
        for center in ("poses", "focus", "none"):
            want = jdp.parse_transforms(jdp.DataparserConfig(
                data=scenes / "jax", orientation_method=method, center_method=center))
            got = tdp.parse_transforms(tdp.DataparserConfig(
                data=scenes / "jax", orientation_method=method, center_method=center))
            for k in ("cam2worlds", "intrinsics", "heights", "widths", "sample_to_camera_idx",
                      "times"):
                assert np.array_equal(getattr(got, k), getattr(want, k)), (method, center, k)
            assert got.image_filenames == want.image_filenames
            assert got.dataparser_scale == want.dataparser_scale
            assert all(np.array_equal(got.joint_positions[k], v)
                       for k, v in want.joint_positions.items())


def _cfgs(root, **kw):
    from neural_jacobian_field_tpu.data.dataset import DatasetCfgCommon as JCfg
    from neural_jacobian_field_torch.data.dataset import DatasetCfgCommon

    common = dict(root=root, num_total_joints=4, max_num_frames_per_traj=3, **kw)
    return JCfg(**common), DatasetCfgCommon(**common)


MODES = {
    "perception": dict(mode="perception"),
    "flow": dict(mode="action"),
    "tracks": dict(mode="action", action_supervision_type="tracks", num_positive_samples=10,
                   num_negative_samples=6),
    "disabled": dict(mode="action", disabled_joints=[1]),
}


def _items(get_dataset, cfg, seed, idxs, stage="train"):
    random.seed(seed)
    np.random.seed(seed)
    ds = get_dataset(cfg, stage)
    return [ds[i] for i in idxs]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            assert gv.dtype == wv.dtype and np.array_equal(gv, wv), k


@pytest.mark.parametrize("decoder", ["native", "pillow"])
@pytest.mark.parametrize("mode", list(MODES))
def test_dataset_items_match_jax(scenes, mode, decoder, monkeypatch):
    from neural_jacobian_field_tpu.data.dataset import get_dataset as jget
    from neural_jacobian_field_torch.data.dataset import get_dataset

    if decoder != "native":  # both packages on the per-item path (the native
        # decoder multiplies by 1/255, a ulp off Pillow's /255)
        from neural_jacobian_field_tpu.data import native as jnative

        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    jcfg, tcfg = _cfgs(scenes / "jax", **MODES[mode])
    idxs = [0, 5, 11, 17, 3, 100]
    before = dict(image_io.DECODED)
    got = _items(get_dataset, tcfg, 7, idxs)
    want = _items(jget, jcfg, 7, idxs)
    _assert_items_equal(got, want)
    used = {k for k, v in image_io.DECODED.items() if v > before.get(k, 0)}
    assert decoder in used or (decoder == "native" and tnative.get_lib() is None)
    if mode == "tracks":
        assert got[0]["pixel_selector"].shape == (16,)


def test_val_stage_items_match_jax(scenes):
    """The val split downscales by 5 (4x3 here, as nerfstudio floors)."""
    from neural_jacobian_field_tpu.data.dataset import get_dataset as jget
    from neural_jacobian_field_torch.data.dataset import get_dataset

    jcfg, tcfg = _cfgs(scenes / "jax", mode="perception")
    ds = get_dataset(tcfg, "val")
    assert ds.load_intrinsics(0)[1] == (16 // 5, 24 // 5)
    assert np.array_equal(ds.outputs.intrinsics, jget(jcfg, "val").outputs.intrinsics)


@pytest.mark.parametrize("mode", ["perception", "flow", "tracks"])
def test_loader_batches_match_jax(scenes, mode):
    from neural_jacobian_field_tpu.data.dataset import get_dataset as jget
    from neural_jacobian_field_tpu.data.loader import DataLoader as JLoader
    from neural_jacobian_field_torch.data import DataLoader, get_dataset

    jcfg, tcfg = _cfgs(scenes / "jax", **MODES[mode])
    tracks = 24 if mode == "tracks" else None

    def batches(loader_cls, get, cfg):
        random.seed(3)
        np.random.seed(3)
        it = iter(loader_cls(get(cfg, "train"), 3, num_tracks=tracks, num_workers=0, seed=5))
        return [next(it) for _ in range(3)]

    got = batches(DataLoader, get_dataset, tcfg)
    want = batches(JLoader, jget, jcfg)
    for g, w in zip(got, want):
        for name in w.__dataclass_fields__:
            wv = getattr(w, name)
            gv = getattr(g, name)
            if wv is None:
                assert gv is None, name
                continue
            assert isinstance(gv, torch.Tensor) and gv.device.type == "cpu"
            assert np.array_equal(gv.numpy(), np.asarray(wv)), name
            assert gv.numpy().dtype == np.asarray(wv).dtype, name
    if mode == "tracks":  # padded to 24: 10 + 6 real entries, the rest masked out
        assert tuple(got[0].pixel_selector.shape) == (3, 24)
        assert float(got[0].pixel_visible_mask[:, 16:].abs().max()) == 0.0


def test_loader_per_item_path_and_threads(scenes, no_native):
    """Without the native decoder the per-item path serves (float32 RGB);
    worker threads deliver batches of the same shapes, and close() stops
    them."""
    from neural_jacobian_field_torch.data import DataLoader, get_dataset

    _, tcfg = _cfgs(scenes / "jax", mode="perception")
    loader = DataLoader(get_dataset(tcfg, "train"), 2, num_workers=2, seed=1)
    it = iter(loader)
    batches = [next(it) for _ in range(4)]
    loader.close()
    assert loader.paths["per-item"] >= 4 and not loader.paths["native"]
    assert all(b.ctxt_rgb.dtype == torch.float32 and b.ctxt_rgb.shape == (2, 16, 24, 3)
               for b in batches)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("mode", ["perception", "tracks"])
def test_sharded_loader_rows_make_the_global_batch(scenes, mode, workers):
    """DataLoader(shard=(rank, size)), the data-parallel loader: the two
    ranks' rows of each global batch, in rank order, are the one-rank
    loader's batch bit for bit, with worker threads or without and whatever
    else draws from the global streams meanwhile; another seed gives other
    batches; a batch that does not divide over the ranks raises."""
    from neural_jacobian_field_torch.data import DataLoader, get_dataset

    _, tcfg = _cfgs(scenes / "port", **MODES[mode])
    ds = get_dataset(tcfg, "train")

    def batches(shard, n_workers=0, seed=5):
        loader = DataLoader(ds, 4, num_tracks=24 if mode == "tracks" else None,
                            num_workers=n_workers, seed=seed, shard=shard)
        it, out = iter(loader), []
        for _ in range(3):
            random.random()  # draws of the global streams between batches
            np.random.rand()
            out.append(next(it))
        loader.close()
        return out

    whole = batches((0, 1))
    parts = [batches((r, 2), workers) for r in range(2)]
    for t, want in enumerate(whole):
        for name in want.__dataclass_fields__:
            w = getattr(want, name)
            if w is None:
                assert getattr(parts[0][t], name) is None, name
                continue
            got = torch.cat([getattr(p[t], name) for p in parts])
            assert got.dtype == w.dtype and torch.equal(got, w), (t, name)
    assert not torch.equal(batches((0, 1), seed=6)[0].ctxt_rgb, whole[0].ctxt_rgb)
    with pytest.raises(ValueError, match="does not divide"):
        DataLoader(ds, 3, shard=(0, 2))


def test_loader_native_path_emits_uint8(scenes):
    from neural_jacobian_field_torch.data import DataLoader, get_dataset

    if tnative.get_lib() is None:
        pytest.skip(f"native decoder {tnative.status()}")
    _, tcfg = _cfgs(scenes / "jax", mode="action")
    loader = DataLoader(get_dataset(tcfg, "train"), 2, num_workers=0)
    b = next(iter(loader))
    assert b.ctxt_rgb.dtype == torch.uint8 and b.flow.shape == (2, 16, 24, 2)
    assert loader.paths["native"] == 1
    assert tnative.status() == "native"
    assert "build" in tnative._LIB_PATH.parts and tnative._LIB_PATH.exists()


def test_collate_pads_and_truncates_tracks():
    from neural_jacobian_field_tpu.data.loader import collate as jcollate
    from neural_jacobian_field_torch.data.loader import collate

    rng = np.random.default_rng(0)

    def item(n):
        return {"ctxt_rgb": rng.uniform(size=(4, 5, 3)).astype(np.float32),
                "near": np.float32(0.5), "pixel_selector": rng.integers(0, 20, n),
                "pixel_motion": rng.normal(size=(n, 2)).astype(np.float32),
                "pixel_visible_mask": np.ones(n, np.float32)}

    items = [item(5), item(12)]
    np.random.seed(1)
    want = jcollate(items, num_tracks=8)
    np.random.seed(1)
    got = collate(items, num_tracks=8)
    for name in ("ctxt_rgb", "near", "pixel_selector", "pixel_motion", "pixel_visible_mask"):
        assert np.array_equal(getattr(got, name).numpy(), getattr(want, name)), name
    assert got.flow is None and float(got.pixel_visible_mask[0, 5:].sum()) == 0.0


# ------------------------------------------------------------ augmentation

@pytest.fixture(scope="module")
def occluders(tmp_path_factory):
    """Fabricated occluder images and a COCO-format root (no download)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("occ")
    rng = np.random.default_rng(4)
    (root / "cut").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (12 + i, 9, 3), dtype=np.uint8)).save(
            root / "cut" / f"o{i}.png")
    coco = root / "coco"
    (coco / "annotations").mkdir(parents=True)
    (coco / "train2017").mkdir()
    images, anns = [], []
    for i in range(4):
        name = f"{i:03d}.png"
        mode = ("RGB", "L", "RGBA", "RGB")[i]
        arr = rng.integers(0, 256, (300, 260) + ((3,) if mode == "RGB" else (4,) if mode == "RGBA"
                                                 else ()), dtype=np.uint8)
        Image.fromarray(arr, mode).save(coco / "train2017" / name)
        images.append({"id": i, "file_name": name})
        for j in range(3):
            w, h = int(rng.integers(60, 250)), int(rng.integers(60, 280))
            anns.append({"image_id": i, "bbox": [int(rng.integers(0, 10)), int(rng.integers(0, 10)),
                                                  w, h], "area": float(w * h), "iscrowd": 0})
    anns.append({"image_id": 0, "bbox": [0, 0, 5, 5], "area": 25.0, "iscrowd": 1})
    (coco / "annotations" / "instances_train2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    return root


@pytest.mark.parametrize("source", ["occluder_dir", "coco_root"])
def test_random_background_matches_jax(occluders, source):
    from neural_jacobian_field_tpu.data.augmentation import RandomBackground as JBg
    from neural_jacobian_field_torch.data.augmentation import RandomBackground

    kw = ({"occluder_dir": occluders / "cut"} if source == "occluder_dir"
          else {"coco_root": occluders / "coco"})
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(32, 40, 3)).astype(np.float32)
    mask = np.zeros((32, 40), np.float32)
    mask[8:20, 10:30] = 1.0
    for seed in range(12):
        random.seed(seed)
        np.random.seed(seed)
        want = JBg(p=0.7, **kw)(img, mask)
        random.seed(seed)
        np.random.seed(seed)
        got = RandomBackground(p=0.7, **kw)(img, mask)
        assert got.dtype == want.dtype and np.array_equal(got, want), seed


def test_coco_occluder_crops_match_jax(occluders):
    from neural_jacobian_field_tpu.data.augmentation import CocoOccluderSource as JCoco
    from neural_jacobian_field_torch.data.augmentation import CocoOccluderSource

    j, t = JCoco(occluders / "coco"), CocoOccluderSource(occluders / "coco")
    seen = 0
    for seed in range(20):
        random.seed(seed)
        np.random.seed(seed)
        want = j.sample()
        random.seed(seed)
        np.random.seed(seed)
        got = t.sample()
        assert (got is None) == (want is None)
        if want is not None:
            seen += 1
            assert np.array_equal(got, want), seed
    assert seen >= 5


def test_zero_mask_and_flips_match_jax():
    from neural_jacobian_field_tpu.data import augmentation as ja
    from neural_jacobian_field_torch.data import augmentation as ta

    img = np.random.default_rng(2).uniform(size=(40, 60, 3)).astype(np.float32)
    pix = np.random.default_rng(3).uniform(0, 40, size=(40, 60, 2)).astype(np.float32)
    for seed in range(4):
        outs = []
        for mod in (ja, ta):
            np.random.seed(seed)
            z = mod.ZeroMaskPatchedImage(patch_size=20, mask_ratio=0.5)(img)
            h = mod.random_horizontal_flip([img], pix)
            v = mod.random_vertical_flip([img], pix)
            r = mod.get_random_image((8, 9, 3))
            outs.append([z, h[0][0], h[1], v[0][0], v[1], r])
        assert all(np.array_equal(a, b) for a, b in zip(*outs)), seed


# ------------------------------------------------------------ image files

def _images():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:40, 0:56]
    smooth = np.stack([(x * 4) % 256, (y * 5) % 256, (x + y) % 256], -1).astype(np.uint8)
    noise = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    mixed = np.where((y // 10 % 2 == 0)[..., None], smooth, noise).astype(np.uint8)
    return {
        "rgb": mixed,
        "rgba": np.concatenate([mixed, rng.integers(0, 256, (40, 56, 1), dtype=np.uint8)], -1),
        "gray8": mixed[..., 0].copy(),
        "gray16": ((x * 900 + y * 37) % 65536).astype(np.uint16),
        "depth16": (rng.uniform(0, 4, (40, 56)) * 1000).astype(np.uint16),
    }


@pytest.mark.parametrize("name", list(_images()) + ["palette", "palette_alpha"])
def test_read_image_matches_pillow(name, tmp_path):
    """read_image gives np.asarray(Image.open(...)), palettes expanded as
    convert("RGB" / "RGBA") expands them, and counts the file."""
    from PIL import Image

    imgs = _images()
    if name.startswith("palette"):
        pil = Image.fromarray(imgs["rgb"]).convert("P")
        if name == "palette_alpha":
            pil.info["transparency"] = 0
        pil.save(tmp_path / "a.png", **({"transparency": 0} if name == "palette_alpha" else {}))
        with Image.open(tmp_path / "a.png") as ref:
            want = np.asarray(ref.convert("RGBA" if name == "palette_alpha" else "RGB"))
    else:
        Image.fromarray(imgs[name]).save(tmp_path / "a.png")
        want = np.asarray(Image.open(tmp_path / "a.png"))
    before = image_io.DECODED["pillow"]
    got = image_io.read_image(tmp_path / "a.png")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert image_io.DECODED["pillow"] == before + 1


@pytest.mark.parametrize("name", ["rgb", "gray16", "depth16"])
def test_writers_match_the_jax_scenes_writer(name, tmp_path):
    """write_rgb / write_depth write the bytes that the JAX package's
    Image.fromarray(...).save(...) writes, and read back unchanged."""
    from PIL import Image

    img = _images()[name]
    write = image_io.write_rgb if img.ndim == 3 else image_io.write_depth
    write(tmp_path / "port.png", img)
    Image.fromarray(img).save(tmp_path / "jax.png")
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    assert np.array_equal(image_io.read_image(tmp_path / "port.png"), img)


@pytest.mark.parametrize("size", [(28, 20), (112, 80), (56, 40)])
def test_resize_bilinear_matches_pillow(size):
    from PIL import Image

    img = _images()["rgb"]
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    got = image_io.resize_bilinear(img, *size)
    assert got.shape == (size[1], size[0], 3) and np.array_equal(got, want)


def test_device_prefetcher_on_cpu():
    from neural_jacobian_field_torch.parallel import DevicePrefetcher
    from neural_jacobian_field_torch.training import RawBatch

    def batches():
        for i in range(5):
            t = torch.full((1,), float(i))
            yield RawBatch(t, t, t, t, t, t, t, t, t, t)
        raise RuntimeError("loader failed")

    pf = DevicePrefetcher(batches(), "cpu", depth=2)
    assert [float(next(pf).near) for _ in range(5)] == [0.0, 1.0, 2.0, 3.0, 4.0]
    with pytest.raises(RuntimeError, match="loader failed"):
        next(pf)
    pf.close()
