"""Operations and bytes of the exact feature path's work
(`pixel_feature_mode: "exact"`), from a configuration's shapes alone: every
sample reads its own bilinear feature from each pyramid level (fine and mid
as rows of their 2x2-packed maps, coarse from the raw map), and each
trunk's combine layers project that point's 512-channel latent themselves.
The encoder, the colour head and the conventions (a trained part's
backward twice its forward, no recomputation) are harness/work.py's."""

from . import work
from .work import BF16, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, latent_dims, pe_dim

F32 = 4
ID = 8  # an int64 row or corner id


def n_lin_z(mlp: dict) -> int:
    return min(mlp["combine_layer"], mlp["n_blocks"])


def trunk_point_flops(model: dict, mlp: dict, d_out: int) -> float:
    """A trunk's forward a point: its layers and, at each of its combine
    layers, the projection of the point's own latent (2 x 512 x 128)."""
    d_in = pe_dim(model["action_decoder"]["num_frequencies"])
    project = n_lin_z(mlp) * 2.0 * sum(latent_dims(model)) * mlp["d_hidden"]
    return work.trunk_layer_flops(mlp, d_in, d_out) + project


def step_flops(model: dict, h: int, w: int, batch: int, rays: int, mode: str,
               updated: bool) -> float:
    """Model operations of one stage-1 train step: the forward, plus the
    backward of what the step trains (the proposal trunk's only on an
    update step)."""
    if mode != "perception":
        raise ValueError(f"the exact path's count covers stage 1 only, not {mode!r}")
    rc = model["rendering"]
    s_prop, s_nerf = rc["num_proposal_samples"][0], rc["num_nerf_samples"]
    act, dens = model["action_decoder"], model["density_decoder"]
    geo = act["geometry_feature_dim"]
    n_prop, n_nerf = batch * rays * s_prop, batch * rays * s_nerf
    total = work.encoder_flops(h, w, batch, backward=True)
    total += trunk_point_flops(model, dens["mlp"], 1) * n_prop * (3 if updated else 1)
    density = trunk_point_flops(model, act["mlp"], geo + 1) * n_nerf
    color = 2.0 * ((geo + 16) * 64 + 64 * 64 + 64 * 3) * n_nerf
    return total + 3 * (density + color)


def call_flops(model: dict, h: int, w: int, batch: int, rays: int, mode: str, gates) -> float:
    return sum(step_flops(model, h, w, batch, rays, mode, g) for g in gates)


def trunk_bound_s(model: dict, mlp: dict, d_out: int, points: int, backward: bool) -> float:
    """The least device time of a projection-mode trunk (K7-fwd, K7-bwd)
    over `points` points: it takes the 512-channel latent ([points, 512]
    bf16) and the encoded coordinates ([points, d_in] bf16) and writes
    [points, d_out] float32; the backward reads those and the output's
    gradient and writes the latent's gradient ([points, 512] bf16)."""
    d_latent = sum(latent_dims(model))
    d_in = pe_dim(model["action_decoder"]["num_frequencies"])
    flops = trunk_point_flops(model, mlp, d_out) * points
    nbytes = points * (d_latent * BF16 + d_in * BF16 + d_out * F32)
    if backward:
        flops *= 2
        nbytes += points * d_latent * BF16
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def field_bound_s(model: dict, batch: int, rays: int, updated: bool) -> float:
    """The least device time of one stage-1 step's trunk work in projection
    mode: the proposal trunk's forward (and its backward on an update step),
    the density trunk's forward and backward."""
    rc = model["rendering"]
    n_prop = batch * rays * rc["num_proposal_samples"][0]
    n_nerf = batch * rays * rc["num_nerf_samples"]
    act, dens = model["action_decoder"], model["density_decoder"]
    geo = act["geometry_feature_dim"] + 1
    t = trunk_bound_s(model, dens["mlp"], 1, n_prop, False)
    if updated:
        t += trunk_bound_s(model, dens["mlp"], 1, n_prop, True)
    return (t + trunk_bound_s(model, act["mlp"], geo, n_nerf, False)
            + trunk_bound_s(model, act["mlp"], geo, n_nerf, True))


def pyramid_hw(h: int, w: int):
    """(H, W) of the fine (conv1), mid (layer2) and coarse (layer3) levels of
    an h x w image."""

    def half(n):  # a stride-2 conv or pool with the padding that keeps ceil(n / 2)
        return (n - 1) // 2 + 1

    fine = (half(h), half(w))
    pooled = (half(fine[0]), half(fine[1]))
    mid = (half(pooled[0]), half(pooled[1]))
    return fine, mid, (half(mid[0]), half(mid[1]))


def gather_bytes(model: dict, h: int, w: int, batch: int, points: int,
                 backward: bool) -> float:
    """Bytes of one call of the per-sample lookups at `points` points
    ([batch, points / batch]) and, with `backward`, of their scatters. Fine
    and mid (128 channels each) are rows of their 2x2-packed maps (4 x 128
    bf16), gathered by id; coarse (256) is read by its four corner ids and
    weights into float32. The forward counts the ids and weights read and
    the samples written, not the maps' texels read: how many distinct
    texels a call's samples touch depends on the data. The scatters read the
    samples' gradients (the packed rows' in bf16; coarse's in bf16) and the
    ids and weights, and write each map's gradient once, dense."""
    fine_c, mid_c, coarse_c = latent_dims(model)
    (hf, wf), (hm, wm), (hc, wc) = pyramid_hw(h, w)
    rows = points * (ID + 4 * fine_c * BF16) + points * (ID + 4 * mid_c * BF16)
    if not backward:
        return rows + points * (4 * ID + 4 * F32 + coarse_c * F32)
    maps = batch * (hf * wf * 4 * fine_c + hm * wm * 4 * mid_c + hc * wc * coarse_c) * BF16
    return rows + points * (4 * ID + 4 * F32 + coarse_c * BF16) + maps


def gather_bound_s(model: dict, h: int, w: int, batch: int, rays: int, updated: bool) -> float:
    """The least device time of one stage-1 step's per-sample lookups and
    their scatters (bytes over the bandwidth): the proposal samples' lookups
    (their scatter only on an update step, when the proposal trunk trains)
    and the NeRF samples' lookups and scatter."""
    rc = model["rendering"]
    n_prop = batch * rays * rc["num_proposal_samples"][0]
    n_nerf = batch * rays * rc["num_nerf_samples"]
    nbytes = gather_bytes(model, h, w, batch, n_prop, False) + gather_bytes(
        model, h, w, batch, n_nerf, False) + gather_bytes(model, h, w, batch, n_nerf, True)
    if updated:
        nbytes += gather_bytes(model, h, w, batch, n_prop, True)
    return nbytes / PEAK_BYTES_PER_S
