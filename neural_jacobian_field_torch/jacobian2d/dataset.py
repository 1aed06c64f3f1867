"""2D trajectory datasets (PyTorch counterpart of jacobian2d/dataset.py):
gzip-pickled trajectories {seq_rgb_obs, seq_qpos, seq_flow_obs}, one random
frame per training item with qpos min-max normalised and the command
`action_scale * delta-qpos`, whole trajectories for validation, an optional
resize (flow vectors rescaled with the resolution), and the synthetic
trajectory writer that stands in for the reference's MuJoCo scenes.

NHWC numpy arrays: rgb [T, H, W, 3] float in [0, 1]; flow [T, H, W, 2] (a
[T, 2, H, W] file is transposed). The frame of an item is drawn from the
dataset's own `random.Random` (JAX's draws from Python's global `random`):
`Dataset2D(cfg, rng=random.Random(s))[i]` draws what JAX's `ds[i]` draws
after `random.seed(s)`, and `item(i, t)` takes the frame given.
"""

import gzip
import pickle
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def load_gzip_file(path):
    with gzip.open(path, "rb") as f:
        return pickle.load(f)


def save_gzip_file(path, obj):
    with gzip.open(path, "wb") as f:
        pickle.dump(obj, f)


@dataclass
class Dataset2DCfg:
    name: str = "pusher"
    root: Path = Path(".")
    command_dim: int = 2
    action_scale: float = 4.0
    # qpos min-max normalisation bounds (pusher_dataset.py:30-33)
    min_qpos: Optional[np.ndarray] = None
    max_qpos: Optional[np.ndarray] = None
    # an optional target size; flow magnitudes rescale with the resolution
    resize_hw: Optional[tuple] = None


DEFAULT_BOUNDS = {
    "pusher": (np.array([-1.7, -1.09], np.float32), np.array([0.4, 1.0], np.float32)),
    # planar hand: 4 joints in [-1, 1]
    "planar_hand": (np.full(4, -1.0, np.float32), np.full(4, 1.0, np.float32)),
}


class Dataset2D:
    """Map-style dataset of (frame, command, flow) samples."""

    repeat: int = 100000
    cache: int = 64  # decoded trajectories held (a few MB each at 252x252)

    def __init__(self, cfg: Dataset2DCfg, stage: str = "train",
                 rng: Optional[random.Random] = None):
        self.cfg, self.stage = cfg, stage
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self.rng = rng if rng is not None else random.Random()
        self.trajectory_paths = sorted(Path(cfg.root, stage).glob("*.pkl"))
        lo, hi = cfg.min_qpos, cfg.max_qpos
        if lo is None or hi is None:
            dlo, dhi = DEFAULT_BOUNDS.get(cfg.name, (None, None))
            # trimmed to command_dim, so that a 1-DoF pusher does not
            # broadcast the 2-dim bounds back into a 2-dim command
            lo = (None if dlo is None else dlo[:cfg.command_dim]) if lo is None else lo
            hi = (None if dhi is None else dhi[:cfg.command_dim]) if hi is None else hi
        self.min_qpos, self.max_qpos = lo, hi

    @property
    def num_files(self) -> int:
        return len(self.trajectory_paths)

    def __len__(self) -> int:
        return self.num_files * (self.repeat if self.stage == "train" else 1)

    def _load(self, idx) -> Dict[str, np.ndarray]:
        """Trajectory idx's arrays, decoded once and held (`cache` of them at
        most; the items are views of them)."""
        key = idx % self.num_files
        if key not in self._cache:
            if len(self._cache) >= self.cache:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = self._decode(key)
        return self._cache[key]

    def _decode(self, key) -> Dict[str, np.ndarray]:
        from ..flow.raft import resize_batched_flow, resize_batched_frames

        traj = load_gzip_file(self.trajectory_paths[key])
        rgb = np.asarray(traj["seq_rgb_obs"], np.float32)
        if rgb.max() > 1.5:  # uint8 storage
            rgb = rgb / 255.0
        flow = np.asarray(traj["seq_flow_obs"], np.float32)
        if flow.ndim == 4 and flow.shape[1] == 2 and flow.shape[-1] != 2:
            flow = flow.transpose(0, 2, 3, 1)  # [T, 2, H, W] -> [T, H, W, 2]
        qpos = np.asarray(traj["seq_qpos"], np.float32)[:, :self.cfg.command_dim]
        qpos = (qpos - self.min_qpos) / (self.max_qpos - self.min_qpos)
        if self.cfg.resize_hw is not None:
            hw = tuple(self.cfg.resize_hw)
            rgb = resize_batched_frames(torch.from_numpy(rgb), hw).contiguous().numpy()
            flow = resize_batched_flow(torch.from_numpy(flow), hw).contiguous().numpy()
        return {"rgb": rgb, "flow": flow, "qpos": qpos}

    def _item(self, traj: dict, t: int) -> Dict[str, np.ndarray]:
        cmd = self.cfg.action_scale * (traj["qpos"][t + 1] - traj["qpos"][t])
        return {"input_frame_curr": traj["rgb"][t], "input_frame_next": traj["rgb"][t + 1],
                "input_command": cmd.astype(np.float32), "trgt_flow_curr": traj["flow"][t]}

    def item(self, idx: int, t: int) -> Dict[str, np.ndarray]:
        """The training item of trajectory idx at frame t."""
        return self._item(self._load(idx), t)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """A training item at a random frame (pusher_dataset.py:65-101)."""
        traj = self._load(idx)
        return self._item(traj, self.rng.randint(0, len(traj["rgb"]) - 2))

    def get_val_item(self, idx: int) -> Dict[str, np.ndarray]:
        """A whole-trajectory validation item (pusher_dataset.py:103-134)."""
        traj = self._load(idx)
        cmds = self.cfg.action_scale * (traj["qpos"][1:] - traj["qpos"][:-1])
        return {"input_video_sequence": traj["rgb"],
                "input_command_sequence": cmds.astype(np.float32),
                "trgt_flow_sequence": traj["flow"]}


def collate_2d(items: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def make_synthetic_trajectories(root, num_trajs: int = 4, num_steps: int = 6, height: int = 32,
                                width: int = 32, command_dim: int = 2, seed: int = 0,
                                stage: str = "train", scene: str = "pusher") -> Path:
    """Synthetic 2D trajectories in place of the reference's MuJoCo scenes
    (the JAX package's writer: the same arrays for the same arguments).

    scene="pusher": a bright square whose position is the qpos; the flow is
    the square's rigid pixel displacement, so the true Jacobian is constant
    on the square and zero elsewhere. scene="planar_hand": two "fingertip"
    squares, one driven by q[0:2], the other by q[2:4] (command_dim 4): a
    block-structured Jacobian."""
    root = Path(root)
    (root / stage).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    if scene == "planar_hand":
        command_dim = 4
    half = 4

    def render_square(img, mask_all, q2, color, x_lo, x_hi):
        """One square, constrained to the horizontal band [x_lo, x_hi)."""
        cx = int((q2[0] * 0.5 + 0.5) * (x_hi - x_lo - 2 * half)) + x_lo + half
        # command_dim 1: y reuses q[0] (the square moves diagonally)
        qy = q2[1] if len(q2) > 1 else q2[0]
        cy = int((qy * 0.5 + 0.5) * (height - 2 * half)) + half
        img[cy - half:cy + half, cx - half:cx + half] = color
        m = np.zeros((height, width), bool)
        m[cy - half:cy + half, cx - half:cx + half] = True
        mask_all.append(m)
        return np.array([cx, cy], np.float32)

    def render(q):
        img = np.full((height, width, 3), 0.15, np.float32)
        masks, centers = [], []
        if scene == "planar_hand":
            centers.append(render_square(img, masks, q[0:2], [0.9, 0.4, 0.2], 0, width // 2))
            centers.append(render_square(img, masks, q[2:4], [0.2, 0.5, 0.9], width // 2,
                                         width))
        else:
            centers.append(render_square(img, masks, q[:2], [0.9, 0.4, 0.2], 0, width))
        return img, masks, centers

    for traj_idx in range(num_trajs):
        q = rng.uniform(-0.6, 0.6, command_dim)
        rgbs, flows, qposs = [], [], []
        for _ in range(num_steps):
            img, masks, c0 = render(q)
            q_next = np.clip(q + rng.normal(0, 0.12, command_dim), -0.8, 0.8)
            _, _, c1 = render(q_next)
            flow = np.zeros((height, width, 2), np.float32)
            for m, a, b in zip(masks, c0, c1):
                flow[m] = b - a
            rgbs.append(img)
            flows.append(flow)
            qposs.append(q.copy())
            q = q_next
        save_gzip_file(root / stage / f"{traj_idx:05d}.pkl", {
            "seq_rgb_obs": np.stack(rgbs),
            "seq_qpos": np.stack(qposs).astype(np.float32),
            "seq_flow_obs": np.stack(flows)})
    return root
