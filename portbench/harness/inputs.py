"""Inputs the benchmark makes for both sides: the camera rig."""

import math


def cameras(traffic: dict, device):
    """(context cam2world, target cam2world, normalized intrinsics): the
    target camera turned about the vertical axis through a point ahead."""
    import torch

    cam = traffic["camera"]
    intr = torch.tensor(cam["intrinsics"], device=device)
    t = math.radians(cam["target_yaw_deg"])
    rot = torch.tensor([[math.cos(t), 0.0, math.sin(t)], [0.0, 1.0, 0.0],
                        [-math.sin(t), 0.0, math.cos(t)]], device=device)
    focus = torch.tensor([0.0, 0.0, cam["focus_m"]], device=device)
    trgt = torch.eye(4, device=device)
    trgt[:3, :3] = rot
    trgt[:3, 3] = focus - rot @ focus
    return torch.eye(4, device=device), trgt, intr
