"""Operations and bytes of the model's work, computed from a configuration's
shapes alone (whatever implements them), and the table of the card's
peaks. A backward of a trained part is counted as twice its forward (the
gradients of its inputs and of its weights); a frozen part has none; the
stem's input gradient is not needed and not counted; recomputation is not
counted."""

from typing import Iterable, List, Tuple

# NVIDIA H100 SXM, NVIDIA's data sheet: dense bf16 tensor rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
STAGES = ((3, 64), (4, 128), (6, 256))  # ResNet-34's first three stages: blocks, channels
BF16 = 2


def encoder_convs(h: int, w: int) -> List[Tuple[int, int, int, int, int, int]]:
    """(kernel, cin, cout, hout, wout, stride) of every conv of the encoder
    (num_layers 4) on an h x w image."""
    h2, w2 = (h + 6 - 7) // 2 + 1, (w + 6 - 7) // 2 + 1
    convs = [(7, 3, 64, h2, w2, 2)]
    hh, ww = (h2 + 2 - 3) // 2 + 1, (w2 + 2 - 3) // 2 + 1  # the max-pool
    cin = 64
    for stage, (n, c) in enumerate(STAGES):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            if stride == 2:
                hh, ww = (hh + 2 - 3) // 2 + 1, (ww + 2 - 3) // 2 + 1
            convs.append((3, cin, c, hh, ww, stride))
            convs.append((3, c, c, hh, ww, 1))
            if stride != 1 or cin != c:
                convs.append((1, cin, c, hh, ww, stride))
            cin = c
    return convs


def conv_flops(conv, batch: int) -> float:
    k, cin, cout, ho, wo, _ = conv
    return 2.0 * k * k * cin * cout * ho * wo * batch


def encoder_flops(h: int, w: int, batch: int, backward: bool) -> float:
    convs = encoder_convs(h, w)
    fwd = sum(conv_flops(c, batch) for c in convs)
    if not backward:
        return fwd
    return 3 * fwd - conv_flops(convs[0], batch)  # no gradient of the image


def stride1_convs(h: int, w: int):
    """The stride-1 3x3 convs (cin, cout, hout, wout): 24 on the encoder."""
    return [c for c in encoder_convs(h, w) if c[0] == 3 and c[5] == 1]


def conv_s1_bound_s(h: int, w: int, batch: int) -> float:
    """The least device time of the stride-1 3x3 convs' forward, input
    gradient and weight gradient: per call the larger of its bf16 operations
    over the peak and its bytes (inputs read once, output written once, all
    in bf16) over the bandwidth, summed."""
    total = 0.0
    for k, cin, cout, ho, wo, _ in stride1_convs(h, w):
        flops = 2.0 * 9 * cin * cout * ho * wo * batch
        act_in, act_out = batch * ho * wo * cin * BF16, batch * ho * wo * cout * BF16
        wgt = 9 * cin * cout * BF16
        for nbytes in (act_in + wgt + act_out,  # forward
                       act_out + wgt + act_in,  # input gradient
                       act_in + act_out + wgt):  # weight gradient
            total += max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
    return total


def trunk_layer_flops(mlp: dict, d_in: int, d_out: int) -> float:
    """Operations a point of one ResnetFC trunk's forward, without its latent
    projection."""
    dh = mlp["d_hidden"]
    return 2.0 * (d_in * dh + 2 * mlp["n_blocks"] * dh * dh + dh * d_out)


def trunk_bound_s(mlp: dict, d_in: int, d_out: int, d_latent_proj: int, points: int,
                  backward: bool) -> float:
    """The least device time of a trunk over `points` points that takes its
    latent already projected ([points, d_latent_proj] bf16) and the encoded
    coordinates ([points, d_in] bf16) and writes [points, d_out] float32; the
    backward reads those and the output's gradient and writes the projected
    latent's gradient."""
    flops = trunk_layer_flops(mlp, d_in, d_out) * points
    nbytes = points * (d_latent_proj * BF16 + d_in * BF16 + d_out * 4)
    if backward:
        flops *= 2
        nbytes += points * d_latent_proj * BF16
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def pe_dim(num_frequencies: int) -> int:
    return 3 * num_frequencies * 2 + 3


def latent_dims(model: dict) -> Tuple[int, int, int]:
    """Channels of the fine, mid and coarse levels."""
    return (64 + STAGES[0][1], STAGES[1][1], STAGES[2][1])


def transformer_flops(model: dict) -> float:
    """Operations a point of the Jacobian transformer's forward."""
    act = model["action_decoder"]
    t = act["transformer"]
    d, inner = t["attn_feat_dim"], t["attn_head_dim"] * t["num_attn_heads"]
    keys = model["action_dim"]
    query = 2.0 * (pe_dim(act["num_frequencies"]) + sum(latent_dims(model))) * d
    layer = 2.0 * (d * inner + 2 * keys * inner + inner * d + 2 * d * t["attn_mlp_dim"])
    return query + t["attn_depth"] * layer + 2.0 * d * 3 * model["action_dim"]


def trunk_point_flops(model: dict, mlp: dict, d_out: int, knots_per_sample: float) -> float:
    """A trunk's forward a point: its layers, the two-tap interpolation of
    each level's projected knots, and its share of the knots' projection."""
    dh = mlp["d_hidden"]
    proj = min(mlp["combine_layer"], mlp["n_blocks"]) * dh
    knots = model["rendering"]["epipolar_knots"]
    project = sum(2.0 * m * c * proj for m, c in zip(knots, latent_dims(model)))
    interp = 3 * 2 * 2.0 * proj
    return (trunk_layer_flops(mlp, pe_dim(model["action_decoder"]["num_frequencies"]), d_out)
            + interp + project * knots_per_sample)


def step_flops(model: dict, h: int, w: int, batch: int, rays: int, mode: str,
               updated: bool) -> float:
    """Model operations of one train step: the forward, plus the backward of
    what the step trains."""
    rc = model["rendering"]
    s_prop, s_nerf = rc["num_proposal_samples"][0], rc["num_nerf_samples"]
    act, dens = model["action_decoder"], model["density_decoder"]
    geo = act["geometry_feature_dim"]
    n_prop, n_nerf = batch * rays * s_prop, batch * rays * s_nerf
    stage1 = mode == "perception"
    total = encoder_flops(h, w, batch, backward=stage1)
    prop = trunk_point_flops(model, dens["mlp"], 1, 1.0 / s_prop) * n_prop
    total += prop * (3 if stage1 and updated else 1)
    density = trunk_point_flops(model, act["mlp"], geo + 1, 1.0 / s_nerf) * n_nerf
    color = 2.0 * ((geo + 16) * 64 + 64 * 64 + 64 * 3) * n_nerf
    total += (density + color) * (3 if stage1 else 1)
    if not stage1:
        if act["name"] == "jacobian_mlp":
            jac = trunk_point_flops(model, act["mlp"], 3 * model["action_dim"], 1.0 / s_nerf)
        else:
            jac = transformer_flops(model)
        total += 3 * jac * n_nerf
    return total


def call_flops(model: dict, h: int, w: int, batch: int, rays: int, mode: str,
               gates: Iterable[bool]) -> float:
    return sum(step_flops(model, h, w, batch, rays, mode, g) for g in gates)


def field_bound_s(model: dict, batch: int, rays: int, mode: str, updated: bool) -> float:
    """The least device time of one step's trunk work as the fused trunk
    kernels take it (projected latent in, output out; forward and
    backward)."""
    rc = model["rendering"]
    s_prop, s_nerf = rc["num_proposal_samples"][0], rc["num_nerf_samples"]
    act, dens = model["action_decoder"], model["density_decoder"]
    d_in = pe_dim(act["num_frequencies"])
    stage1 = mode == "perception"

    def proj(mlp):
        return min(mlp["combine_layer"], mlp["n_blocks"]) * mlp["d_hidden"]

    n_prop, n_nerf = batch * rays * s_prop, batch * rays * s_nerf
    t = trunk_bound_s(dens["mlp"], d_in, 1, proj(dens["mlp"]), n_prop, False)
    if stage1 and updated:
        t += trunk_bound_s(dens["mlp"], d_in, 1, proj(dens["mlp"]), n_prop, True)
    geo = act["geometry_feature_dim"] + 1
    t += trunk_bound_s(act["mlp"], d_in, geo, proj(act["mlp"]), n_nerf, False)
    if stage1:
        t += trunk_bound_s(act["mlp"], d_in, geo, proj(act["mlp"]), n_nerf, True)
    elif act["name"] == "jacobian_mlp":
        d_out = 3 * model["action_dim"]
        for backward in (False, True):
            t += trunk_bound_s(act["mlp"], d_in, d_out, proj(act["mlp"]), n_nerf, backward)
    return t
