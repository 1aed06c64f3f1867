"""Optical flow (PyTorch counterpart of the JAX package's flow/): RAFT at
raft_large's widths and its video, resize and checkpoint helpers."""

from .raft import (
    RAFT,
    InputPadder,
    compute_video_flow,
    load_torch_raft_state_dict,
    resize_batched_flow,
    resize_batched_frames,
)
