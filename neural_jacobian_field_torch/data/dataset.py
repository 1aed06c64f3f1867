"""Host-side dataset: nerfstudio-format scenes -> RawBatch items (the port's
copy of data/dataset.py, NumPy only). Per-item work (image, depth and flow
loading, context/target view pairing, qpos -> normalized action deltas)
stays on the host; pixel subsampling and ray generation happen on the
device (training/prepare.py). The items are the JAX package's: the same
draws from the global `random` and `np.random` (through data/streams.py,
which can seed an item's own streams instead), in the same order, so the
same seeds give the same items. Images are read by data/image_io.py
(Pillow), or by the native batch decoder (data/native.py) where it
builds."""

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import conventions as cv
from . import image_io
from .dataparser import DataparserConfig, merge_dataparser_outputs, parse_transforms
from .streams import nprandom, pyrandom


@dataclass
class DatasetCfgCommon:
    """data/dataset/dataset.py:80-99."""

    name: str = "allegro"
    mode: str = "perception"  # perception | action
    overfit_to_scene: Optional[str] = None
    root: Path = Path(".")
    other_roots: Optional[List[Path]] = None
    num_total_joints: int = 16
    disabled_joints: Optional[List[int]] = None
    max_frame_displacement: int = 1
    max_num_frames_per_traj: int = 10
    action_supervision_type: str = "optical_flow"  # optical_flow | tracks
    num_positive_samples: Optional[int] = None
    num_negative_samples: Optional[int] = None
    augment_ctxt_image: bool = False
    # occluder sources for the augmentation's paste branch: a COCO2017-format
    # root (reference parity, image_augmentation.py:96-100) or any directory
    # of cutout images (zero-egress stand-in); None disables pasting
    coco_root: Optional[Path] = None
    occluder_dir: Optional[Path] = None
    testing_mask_ratio: Optional[float] = None


def load_image(path, scale_factor: float = 1.0,
               expected_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """uint8 image -> float32 [H, W, 3] in [0, 1]. Fast path: the native
    decoder (csrc/njf_loader.cpp) when the expected size is known and no
    rescale is needed; data/image_io.py otherwise."""
    if scale_factor == 1.0 and expected_hw is not None:
        from .native import decode_rgb_batch

        try:
            out = decode_rgb_batch([path], *expected_hw, threads=1)
            if out is not None:
                return out[0]
        except IOError:
            pass  # fall through (odd formats, size mismatch)
    img = image_io.read_image(path)
    if scale_factor != 1.0:
        h, w = img.shape[:2]
        img = image_io.resize_bilinear(img, int(w * scale_factor), int(h * scale_factor))
    arr = np.asarray(img).astype(np.float32) / 255.0
    return arr[..., :3]


def load_depth(path, scale_factor: float,
               expected_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Depth file -> float32 [H, W, 1] meters * dataparser scale (16-bit png
    in mm, .npy or .npz)."""
    path = str(path)
    if path.endswith(".png") and expected_hw is not None:
        from .native import decode_depth_batch

        try:
            out = decode_depth_batch([path], *expected_hw, scale=scale_factor,
                                     threads=1)
            if out is not None:
                return out[0]
        except IOError:
            pass
    if path.endswith(".npy"):
        depth = np.load(path).astype(np.float32) * scale_factor
    elif path.endswith(".npz"):
        depth = next(iter(np.load(path).values())).astype(np.float32) * scale_factor
    else:
        depth = np.asarray(image_io.read_image(path)).astype(np.float32) * scale_factor
    if depth.ndim == 2:
        depth = depth[..., None]
    return depth[..., :1]


def load_optical_flow(path) -> np.ndarray:
    """RAFT-precomputed flow .npz -> [H, W, 2] (io_utils.load_optical_flow)."""
    data = np.load(path)
    flow = data["flow"] if "flow" in data else next(iter(data.values()))
    flow = np.asarray(flow, dtype=np.float32)
    if flow.shape[0] == 2 and flow.ndim == 3:  # stored [2, H, W]
        flow = flow.transpose(1, 2, 0)
    return flow


class DatasetCommon:
    """Iterable map-style dataset yielding RawBatch-shaped item dicts."""

    near: float = 0.5
    far: float = 10.0
    repeat: int = 1000
    scale_factor: float = 1.0

    def __init__(self, cfg: DatasetCfgCommon, stage: str = "train"):
        self.cfg = cfg
        self.stage = stage
        downscale = 1 if stage in ("train", "test") else 5
        parser_cfg = DataparserConfig(
            data=Path(cfg.root), center_method="focus", downscale_factor=downscale,
        )
        outputs = parse_transforms(parser_cfg)
        if cfg.other_roots:
            others = [
                parse_transforms(DataparserConfig(
                    data=Path(r), center_method="focus", downscale_factor=downscale))
                for r in cfg.other_roots
            ]
            outputs = merge_dataparser_outputs([outputs] + others)
        self.outputs = outputs

        qpos = np.stack(list(outputs.joint_positions.values()), axis=0) \
            if outputs.joint_positions else np.zeros((1, cfg.num_total_joints), np.float32)
        self.qpos_minimum = qpos.min(0).astype(np.float32)
        self.qpos_maximum = qpos.max(0).astype(np.float32)
        disabled = set(cfg.disabled_joints or [])
        self.active_joints = [j for j in range(cfg.num_total_joints) if j not in disabled]

        # augmentation hooks (dataset.py:117-124)
        from .augmentation import RandomBackground, ZeroMaskPatchedImage

        self.random_background = (
            RandomBackground(coco_root=cfg.coco_root, occluder_dir=cfg.occluder_dir)
            if cfg.augment_ctxt_image else None
        )
        self.zero_background = None
        if stage == "test" and cfg.testing_mask_ratio is not None:
            self.zero_background = ZeroMaskPatchedImage(
                patch_size=20, mask_ratio=cfg.testing_mask_ratio)

    # -- per-robot hooks (dataset.py:219-222) --------------------------------

    def preprocess_qpos(self, curr, nxt, qmin, qmax):
        return curr, nxt, qmin, qmax

    def get_max_num_frames_per_traj(self, traj_idx: int) -> int:
        return self.cfg.max_num_frames_per_traj

    # -- loading helpers ------------------------------------------------------

    @property
    def num_files(self) -> int:
        return len(self.outputs.image_filenames)

    def __len__(self) -> int:
        return self.num_files * self.repeat

    @property
    def action_dim(self) -> int:
        return len(self.active_joints)

    def load_extrinsics(self, camera_idx: int) -> np.ndarray:
        return cv.post_process_camera_to_world(self.outputs.cam2worlds[camera_idx])

    def load_intrinsics(self, camera_idx: int):
        intr = self.outputs.intrinsics[camera_idx]
        h = int(self.outputs.heights[camera_idx])
        w = int(self.outputs.widths[camera_idx])
        return cv.normalize_intrinsics(intr, h, w), (h, w)

    def load_robot_action(self, traj_idx: int, curr_frame_idx: int,
                          next_frame_idx: int) -> np.ndarray:
        """Normalized action delta (dataset.py:223-275)."""
        curr = self.outputs.joint_positions[f"{traj_idx:05d}_{curr_frame_idx:05d}"].copy()
        nxt = self.outputs.joint_positions[f"{traj_idx:05d}_{next_frame_idx:05d}"].copy()
        curr, nxt, qmin, qmax = self.preprocess_qpos(
            curr, nxt, self.qpos_minimum.copy(), self.qpos_maximum.copy()
        )
        span = np.where(qmax - qmin == 0, 1.0, qmax - qmin)
        curr_n = cv.normalize(curr, qmin, qmin + span, -1.0, 1.0)
        next_n = cv.normalize(nxt, qmin, qmin + span, -1.0, 1.0)
        action = (next_n - curr_n) / 2.0
        return action[self.active_joints].astype(np.float32)

    def random_select_action_type(self, curr_frame_idx, frame_displacement,
                                  max_num_frames) -> str:
        """dataset.py:208-217."""
        if curr_frame_idx <= frame_displacement - 1:
            return "fwd"
        if curr_frame_idx >= max_num_frames - frame_displacement:
            return "bwd"
        return pyrandom().choice(["fwd", "bwd"])

    # -- item assembly ---------------------------------------------------------

    def plan_item(self, ctxt_file_idx: int) -> Dict:
        """All random choices + host metadata for one item, WITHOUT decoding
        any files. `__getitem__` materializes a plan one item at a time; the
        loader's native fast path materializes a whole batch of plans with
        one threaded C++ call per modality (GIL released throughout)."""
        ctxt_file_idx = ctxt_file_idx % self.num_files
        if self.cfg.overfit_to_scene is not None:
            ctxt_file_idx = int(self.cfg.overfit_to_scene)

        ctxt_cam_idx = int(self.outputs.sample_to_camera_idx[ctxt_file_idx])
        trgt_cam_idx = pyrandom().randrange(len(self.outputs.cam2worlds))

        ctxt_img_filename = self.outputs.image_filenames[ctxt_file_idx]
        trgt_img_filename = cv.get_trgt_view_filename(
            str(ctxt_img_filename), ctxt_cam_idx, trgt_cam_idx
        )

        # relative extrinsics: context frame = identity (dataset.py:363-365)
        ctxt_c2w = self.load_extrinsics(ctxt_cam_idx)
        trgt_c2w = self.load_extrinsics(trgt_cam_idx)
        trgt_c2w = np.linalg.inv(ctxt_c2w) @ trgt_c2w

        plan = {
            "ctxt_path": ctxt_img_filename,
            "trgt_path": trgt_img_filename,
            "hw_ctxt": (int(self.outputs.heights[ctxt_cam_idx]),
                        int(self.outputs.widths[ctxt_cam_idx])),
            "hw_trgt": (int(self.outputs.heights[trgt_cam_idx]),
                        int(self.outputs.widths[trgt_cam_idx])),
            "depth_path": str(trgt_img_filename).replace("rgb", "depth"),
            "depth_scale": (self.outputs.depth_unit_scale_factor
                            * self.outputs.dataparser_scale),
            "ctxt_extrinsics": np.eye(4, dtype=np.float32),
            "trgt_extrinsics": trgt_c2w.astype(np.float32),
            "ctxt_intrinsics": self.load_intrinsics(ctxt_cam_idx)[0],
            "trgt_intrinsics": self.load_intrinsics(trgt_cam_idx)[0],
            "robot_action": np.zeros((self.action_dim,), np.float32),
            "near": np.float32(self.near),
            "far": np.float32(self.far),
            "flow_path": None,
            "tracks_args": None,
        }

        if self.cfg.mode == "action":
            traj_idx, curr_frame_idx = cv.get_traj_and_frame_idx(trgt_img_filename)
            displacement = pyrandom().randint(1, self.cfg.max_frame_displacement)
            flow_type = self.random_select_action_type(
                curr_frame_idx, displacement, self.get_max_num_frames_per_traj(traj_idx)
            )
            next_frame_idx = (curr_frame_idx + displacement if flow_type == "fwd"
                              else curr_frame_idx - displacement)
            plan["robot_action"] = self.load_robot_action(
                traj_idx, curr_frame_idx, next_frame_idx
            )
            if self.cfg.action_supervision_type == "optical_flow":
                plan["flow_path"] = cv.get_optical_flow_filename(
                    trgt_img_filename, traj_idx, curr_frame_idx, flow_type
                )
            else:
                plan["tracks_args"] = (trgt_img_filename, traj_idx,
                                       curr_frame_idx, next_frame_idx)
        return plan

    @property
    def needs_python_items(self) -> bool:
        """True when per-item Python work (augmentation, masking) forbids the
        loader's batched native materialization."""
        return (self.random_background is not None
                or self.zero_background is not None
                or self.scale_factor != 1.0)

    def _plan_to_item(self, plan: Dict) -> Dict[str, np.ndarray]:
        item = {k: plan[k] for k in (
            "ctxt_extrinsics", "trgt_extrinsics", "ctxt_intrinsics",
            "trgt_intrinsics", "robot_action", "near", "far")}
        return item

    def __getitem__(self, ctxt_file_idx: int) -> Dict[str, np.ndarray]:
        plan = self.plan_item(ctxt_file_idx)
        try:
            ctxt_rgb = load_image(plan["ctxt_path"], self.scale_factor,
                                  plan["hw_ctxt"])
            trgt_rgb = load_image(plan["trgt_path"], self.scale_factor,
                                  plan["hw_trgt"])
        except OSError:
            # corrupt-image retry with a random resample (dataset.py:345-354)
            return self.__getitem__(pyrandom().randint(0, self.num_files - 1))

        trgt_depth = load_depth(plan["depth_path"], plan["depth_scale"],
                                plan["hw_trgt"])

        if self.random_background is not None:
            mask_path = str(plan["ctxt_path"]).replace("rgb", "mask").replace(".png", ".npy")
            try:
                mask = np.load(mask_path).astype(np.float32)
                ctxt_rgb = self.random_background(ctxt_rgb, mask)
            except FileNotFoundError:
                pass
        if self.zero_background is not None:
            ctxt_rgb = self.zero_background(ctxt_rgb)

        item = self._plan_to_item(plan)
        item.update({
            "ctxt_rgb": ctxt_rgb.astype(np.float32),
            "trgt_rgb": trgt_rgb.astype(np.float32),
            "trgt_depth": trgt_depth,
        })
        if plan["flow_path"] is not None:
            item["flow"] = load_optical_flow(plan["flow_path"])
        elif plan["tracks_args"] is not None:
            item.update(self.load_tracks_supervision(
                *plan["tracks_args"], image_width=trgt_rgb.shape[1]))
        return item

    def load_tracks_supervision(self, trgt_img_filename, traj_idx, curr_frame_idx,
                                next_frame_idx, image_width) -> Dict[str, np.ndarray]:
        """TAPIR track supervision: positive tracks + negative background
        pixels (dataset.py:492-552, io_utils.py:117-163)."""
        files = cv.get_tracking_data_filenames(trgt_img_filename, traj_idx, curr_frame_idx)
        if not files:
            raise FileNotFoundError(
                f"no TAPIR tracks for {trgt_img_filename} (traj {traj_idx})"
            )
        data = np.load(files[0])
        tracks = np.asarray(data["point_track_data"], np.float32)  # [N, T, 2] xy
        visible = np.asarray(data["pixel_visible_mask"], np.float32)  # [N, T]
        negative_yx = np.asarray(data.get("negative_yx", np.zeros((0, 2))), np.float32)

        if self.cfg.num_positive_samples is not None:
            sel = nprandom().permutation(len(tracks))[: self.cfg.num_positive_samples]
            tracks, visible = tracks[sel], visible[sel]
        if self.cfg.num_negative_samples is not None and len(negative_yx):
            sel = nprandom().permutation(len(negative_yx))[: self.cfg.num_negative_samples]
            negative_yx = negative_yx[sel]

        curr = tracks[:, curr_frame_idx]  # [N, 2] xy
        nxt = tracks[:, next_frame_idx]
        flow = nxt - curr  # xy
        selector_yx = np.concatenate(
            [np.stack([curr[:, 1], curr[:, 0]], -1), negative_yx], axis=0
        )
        pixel_selector = np.round(
            selector_yx[:, 0] * image_width + selector_yx[:, 1]
        ).astype(np.int64)
        pixel_motion = np.concatenate([flow, np.zeros_like(negative_yx)], axis=0)
        pixel_visible_mask = np.concatenate(
            [visible[:, next_frame_idx], np.ones(len(negative_yx), np.float32)]
        )
        return {
            "pixel_selector": pixel_selector,
            "pixel_motion": pixel_motion.astype(np.float32),
            "pixel_visible_mask": pixel_visible_mask,
        }


# -- per-robot variants (dataset_{allegro,toy_arm,hsa,pneumatic}.py) ----------


class DatasetAllegro(DatasetCommon):
    pass


class DatasetToyArm(DatasetCommon):
    pass


class DatasetHsa(DatasetCommon):
    def get_max_num_frames_per_traj(self, traj_idx: int) -> int:
        """dataset_hsa.py:32-33: trajectory 511 is one frame short."""
        return 7 if traj_idx == 511 else self.cfg.max_num_frames_per_traj


def process_joints_new_hand(qmin, qmax, curr, nxt):
    """Pairwise-sum servo channels for the new pneumatic hand
    (dataset_pneumatic.py:12-29)."""

    def fold(x):
        out = x[::2].copy()
        out[:-1] += x[:-1][1::2]
        return out

    return fold(qmin), fold(qmax), fold(curr), fold(nxt)


def process_joints_move_arm(qmin, qmax, curr, nxt):
    """dataset_pneumatic.py:43-52."""
    return qmin[:2], qmax[:2], curr[:2], nxt[:2]


class DatasetPneumaticHandOnly(DatasetCommon):
    def preprocess_qpos(self, curr, nxt, qmin, qmax):
        """dataset_pneumatic.py:74-110."""
        if len(curr) == 11:
            qmin, qmax, curr, nxt = process_joints_new_hand(qmin, qmax, curr, nxt)
        else:
            qmin, qmax, curr, nxt = process_joints_move_arm(qmin, qmax, curr, nxt)
        return curr, nxt, qmin, qmax


DATASETS = {
    "allegro": DatasetAllegro,
    "toy_arm": DatasetToyArm,
    "hsa": DatasetHsa,
    "pneumatic_hand_only": DatasetPneumaticHandOnly,
}


def get_dataset(cfg: DatasetCfgCommon, stage: str = "train") -> DatasetCommon:
    """Registry dispatch (data/data_module.py:14-27)."""
    return DATASETS[cfg.name](cfg, stage)
