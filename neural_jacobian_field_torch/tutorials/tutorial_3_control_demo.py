"""Tutorial 3: closed-loop least-squares control with the 2D Jacobian field
(the control demo's cell 14): per step the Jacobian field on the
observation, J at the tracked pixels, du = lstsq(J, desired pixel motion),
a step of the system. The reference steps a MuJoCo env and re-tracks with
CoTracker; here the system is the synthetic square world, whose dynamics
are the Jacobian, so the loop runs self-contained (swap
`SyntheticSquareEnv` for a MuJoCo env and a tracker for the real demo).

Run after tutorial 1:
  python -m neural_jacobian_field_torch.tutorials.tutorial_3_control_demo \\
      [--iters 20] [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ..jacobian2d import UnetJacobianField, UnetJacobianFieldCfg, control_step
from ..jacobian2d.dataset import DEFAULT_BOUNDS
from ..train2d import load_params_2d
from ..utils.device import resolve_device


class SyntheticSquareEnv:
    """The square world of make_synthetic_trajectories, as a steppable env."""

    def __init__(self, hw=64, half=8):
        self.hw, self.half = hw, half
        self.q = np.array([-0.4, 0.3])

    def render(self):
        img = np.full((self.hw, self.hw, 3), 0.15, np.float32)
        cx, cy = self._center()
        img[cy - self.half:cy + self.half, cx - self.half:cx + self.half] = [0.9, 0.4, 0.2]
        return img

    def _center(self):
        s = self.hw - 2 * self.half
        return (int((self.q[0] * 0.5 + 0.5) * s) + self.half,
                int((self.q[1] * 0.5 + 0.5) * s) + self.half)

    def tracked_pixels(self, n=16):
        cx, cy = self._center()
        rng = np.random.default_rng(0)
        off = rng.integers(-self.half + 1, self.half - 1, (n, 2))
        return np.stack([cy + off[:, 0], cx + off[:, 1]], -1)  # yx

    def step(self, dq):
        self.q = np.clip(self.q + dq, -0.8, 0.8)


def closed_loop(model, env, target, iters: int = 20, log=print) -> list:
    """The control loop from env to target's square; returns the pixel
    distance after each step (it stops within 2 px)."""
    dev = next(model.parameters()).device
    tx, ty = target._center()
    # the model was trained on action_scale * the normalised dq
    lo, hi = DEFAULT_BOUNDS["pusher"]
    dists = []
    for it in range(iters):
        obs = torch.from_numpy(env.render())[None].to(dev)
        yx = env.tracked_pixels()
        cx, cy = env._center()
        desired = np.clip(np.tile([[tx - cx, ty - cy]], (len(yx), 1)).astype(np.float32),
                          -6, 6)  # a local linearisation
        u = control_step(model, obs, torch.from_numpy(yx).to(dev),
                         torch.from_numpy(desired).to(dev), damping=1e-3).cpu().numpy()
        dq = u / 4.0 * (hi - lo)  # undo the normalisation: u = 4 dq / (hi - lo)
        env.step(np.clip(dq, -0.1, 0.1))
        dists.append(float(np.hypot(tx - env._center()[0], ty - env._center()[1])))
        log(f"iter {it}: command={np.round(u, 3)} pixel dist={dists[-1]:.1f}")
        if dists[-1] < 2:
            log("reached target")
            break
    return dists


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="/tmp/njf_2d_data/params.npz")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "tutorial 3")

    model = UnetJacobianField(UnetJacobianFieldCfg())
    if Path(args.params).exists():
        load_params_2d(model, args.params)
        print("loaded trained params")
    else:
        model.init_weights(torch.Generator().manual_seed(0))
        print("WARNING: no trained params found (run tutorial 1 first); using random init: "
              "control will not converge")
    model = model.to(dev).eval()
    target = SyntheticSquareEnv()
    target.q = np.array([0.5, -0.5])
    return closed_loop(model, SyntheticSquareEnv(), target, args.iters)


if __name__ == "__main__":
    main()
