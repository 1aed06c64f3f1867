"""Closed-loop least-squares control from the 2D Jacobian field (PyTorch
counterpart of jacobian2d/control.py; the control demo's core step,
3_control_demo_block_pushing.ipynb cell 14): the per-pixel Jacobian at
tracked pixels, the desired pixel motion, and the damped least-squares
command du = (A^T A + damping I)^-1 A^T v over the [N * S, C] system.

On the device without a host sync (torch.linalg.solve_ex, which does not
check the solve on the host): the command stays on the card until the
caller reads it. The environment and the tracker stay on the host.
"""

from typing import Optional

import torch


@torch.no_grad()
def control_step(model, obs_image: torch.Tensor, pixel_yx: torch.Tensor,
                 desired_motion: torch.Tensor, visible: Optional[torch.Tensor] = None,
                 damping: float = 1e-4, spatial_dim: int = 2) -> torch.Tensor:
    """obs_image [1, H, W, 3]; pixel_yx [N, 2] integer pixel (y, x);
    desired_motion [N, 2]; visible [N] 0/1 -> the command [C] minimising
    ||J(pixels) du - desired||^2 + damping ||du||^2."""
    jac = model.compute_jacobian(obs_image)
    h, w = jac.shape[1:3]
    flat = jac.reshape(jac.shape[0], h * w, -1)[0]
    idx = pixel_yx[:, 0].long() * w + pixel_yx[:, 1].long()
    j = flat[idx].reshape(len(idx), -1, spatial_dim).transpose(-1, -2)  # [N, S, C]
    # dtypes promote as in JAX: the Jacobian's float32 products, the rest
    # in the promotion with the motion's (and the mask's) dtype
    if visible is not None:
        j = j * visible[:, None, None]
        desired_motion = desired_motion * visible[:, None]
    a = j.reshape(-1, j.shape[-1])  # [N * S, C]
    b = desired_motion.reshape(-1)
    dt = torch.promote_types(a.dtype, b.dtype)
    ata = (a.T @ a).to(dt) + damping * torch.eye(a.shape[-1], dtype=dt, device=a.device)
    du, _ = torch.linalg.solve_ex(ata, (a.to(dt).T @ b.to(dt))[:, None])
    return du[:, 0]
