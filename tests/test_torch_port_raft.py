"""The port's RAFT (flow/raft.py) against the JAX package's, on the CPU.

JAX's RAFT with seeded parameters (shapes from eval_shape, values drawn with
numpy: frozen-BatchNorm statistics and biases included) goes through the
weight bridge into the port's. Both run float32 convolutions, the same
matmul for the correlation volume and the same gathers; what differs is
the order of sums (convolution algorithms, reductions), ~1e-6 of scale
after 3 iterations here (measured 1.2e-6 on the full-resolution flow), so
flows are held at 1e-5 of scale. 3 GRU iterations at 64x72 (JAX compiles
the unrolled loop; at least 64 px a side keeps every correlation level
non-empty there), one module-scoped set of JAX programs. Exact where both
sides copy data: InputPadder, the checkpoint loaders, the empty
correlation level's zeros. The resizes: bilinear with JAX's antialiasing
when downscaling, 1e-5 of scale.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

ITERS = 3
HW = (64, 72)
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"max err {err:.3e} > {tol:.1e}"


def _seeded_params(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(size=s.shape) / math.sqrt(fan_in)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:  # bias, mean
            v = 0.05 * rng.normal(size=s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _video(t=4):
    """t frames of a seeded texture drifting 2 px right per frame."""
    rng = np.random.default_rng(1)
    h, w = HW
    base = rng.uniform(size=(h, w + 2 * t, 3)).astype(np.float32)
    return np.stack([base[:, 2 * (t - i):2 * (t - i) + w] for i in range(t)])


@pytest.fixture(scope="module")
def raft():
    """JAX RAFT and its seeded params; the port's RAFT with them bridged;
    the JAX flows of the video's forward and backward pairs."""
    from neural_jacobian_field_tpu.flow import RAFT as JRAFT
    from neural_jacobian_field_torch.flow import RAFT

    jr = JRAFT(num_iters=ITERS)
    video = _video()
    x = jnp.asarray(video[:1])
    params = _seeded_params(jax.eval_shape(jr.init, jax.random.PRNGKey(0), x, x))["params"]
    full = jax.jit(lambda a, b: jr.apply({"params": params}, a, b))
    low = jax.jit(lambda a, b: jr.apply({"params": params}, a, b, return_low_res=True))
    want = {"fwd": np.asarray(full(video[:-1], video[1:])),
            "bwd": np.asarray(full(video[1:], video[:-1])),
            "low": np.asarray(low(video[:-1], video[1:]))}
    tr = RAFT(num_iters=ITERS, device="cpu")
    tr.load_state_dict(from_jax_variables(params), strict=True)
    return dict(jr=jr, params=params, port=tr, video=video, want=want)


def test_flow_and_low_res_flow_match_jax(raft):
    v = torch.from_numpy(raft["video"])
    with torch.no_grad():
        flow = raft["port"](v[:-1], v[1:])
        low = raft["port"](v[:-1], v[1:], return_low_res=True)
    assert flow.shape == (3, *HW, 2) and low.shape == (3, HW[0] // 8, HW[1] // 8, 2)
    _close(flow, raft["want"]["fwd"])
    _close(low, raft["want"]["low"])
    # the random field moves pixels: the comparison is not of zeros
    assert np.abs(raft["want"]["fwd"]).max() > 1.0


@pytest.mark.parametrize("backward", [False, True])
def test_compute_video_flow_ragged_chunks_match_jax(raft, backward):
    """4 frames, 3 pairs in chunks of 2 and 1, the video on the host."""
    from neural_jacobian_field_torch.flow import compute_video_flow

    got = compute_video_flow(raft["port"], torch.from_numpy(raft["video"]), chunk=2,
                             backward=backward)
    assert got.shape == (3, *HW, 2)
    _close(got, raft["want"]["bwd" if backward else "fwd"])


def test_frozen_batchnorm_bridges_to_buffers(raft):
    """RAFT's frozen BatchNorm keeps mean / var among JAX's params; the
    bridge puts them in the buffers the port's module reads."""
    cnet = raft["params"]["cnet"]["layer2_0"]["norm3"]
    bn = raft["port"].cnet.layer2_0.norm3
    assert torch.equal(bn.running_mean, torch.from_numpy(cnet["mean"]))
    assert torch.equal(bn.running_var, torch.from_numpy(cnet["var"]))
    assert "cnet.layer2_0.norm3.running_var" in dict(raft["port"].named_buffers())


def test_empty_correlation_level_reads_zeros(raft):
    """Below 64 px a side the coarsest level is empty (32x40: 4x5, 2x2, 1x1,
    0x0): JAX's lookup reads zeros there, and so does the port's; the pyramid
    and the lookup against JAX's, then one whole iteration at 32x40."""
    from neural_jacobian_field_tpu.flow import raft as jraft
    from neural_jacobian_field_torch.flow import raft as traft

    rng = np.random.default_rng(2)
    f1, f2 = (rng.normal(size=(2, 4, 5, 16)).astype(np.float32) for _ in range(2))
    coords = (rng.uniform(-1, 6, size=(2, 4, 5, 2))).astype(np.float32)
    jp = jraft._corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    tp = traft.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(p.shape) for p in tp] == [p.shape for p in jp]
    assert tp[-1].shape[1:3] == (0, 0)
    for got, want in zip(tp[:-1], jp[:-1]):
        _close(got, want, 1e-6)
    got = traft.corr_lookup(tp, torch.from_numpy(coords))
    want = np.asarray(jraft._corr_lookup(jp, jnp.asarray(coords)))
    assert got.shape == (2, 4, 5, 4 * 81)
    assert not want[..., 3 * 81:].any() and not got[..., 3 * 81:].any()
    _close(got, want, 1e-6)

    jr1 = jraft.RAFT(num_iters=1)
    a, b = (rng.uniform(size=(1, 32, 40, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(lambda x, y: jr1.apply({"params": raft["params"]}, x, y))(a, b))
    port = traft.RAFT(num_iters=1, device="cpu")
    port.load_state_dict(raft["port"].state_dict())
    with torch.no_grad():
        _close(port(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("shape", [(1, 30, 37, 3), (2, 33, 40, 2), (1, 64, 72, 3)])
def test_input_padder_matches_jax(shape):
    from neural_jacobian_field_tpu.flow import InputPadder as JPadder
    from neural_jacobian_field_torch.flow import InputPadder

    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got, want = InputPadder(shape).pad(torch.from_numpy(x)), JPadder(shape).pad(jnp.asarray(x))
    assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    assert np.array_equal(got.numpy(), np.asarray(want))
    two = InputPadder(shape).pad(torch.from_numpy(x), torch.from_numpy(x))
    assert len(two) == 2 and torch.equal(two[1], got)
    assert torch.equal(InputPadder(shape).unpad(got), torch.from_numpy(x))
    assert np.array_equal(InputPadder(shape).unpad(got).numpy(),
                          np.asarray(JPadder(shape).unpad(want)))


@pytest.mark.parametrize("src,dst", [((16, 24), (8, 10)), ((16, 24), (40, 36)),
                                     ((30, 20), (17, 45))])
def test_resizes_match_jax(src, dst):
    """Down (antialiased in JAX), up, and one axis each way."""
    from neural_jacobian_field_tpu.flow import resize_batched_flow as jflow
    from neural_jacobian_field_tpu.flow import resize_batched_frames as jframes
    from neural_jacobian_field_torch.flow import resize_batched_flow, resize_batched_frames

    rng = np.random.default_rng(4)
    flow = rng.normal(size=(2, *src, 2)).astype(np.float32)
    frames = rng.uniform(size=(2, *src, 3)).astype(np.float32)
    _close(resize_batched_flow(torch.from_numpy(flow), dst), jflow(jnp.asarray(flow), dst))
    _close(resize_batched_frames(torch.from_numpy(frames), dst),
           jframes(jnp.asarray(frames), dst))
    # magnitudes scale with the resolution
    ones = resize_batched_flow(torch.ones(1, *src, 2), dst)
    assert torch.allclose(ones[..., 0], torch.tensor(dst[1] / src[1]))
    assert torch.allclose(ones[..., 1], torch.tensor(dst[0] / src[0]))


def _to_torchvision(sd: dict) -> dict:
    """princeton-vl names -> torchvision raft_large's (the inverse of the
    loaders' rename), dropping the 'module.' prefix and the downsample.1
    aliases torchvision does not have."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):]
        stem, _, leaf = k.rpartition(".")
        parts = stem.split(".")
        if parts[0] in ("fnet", "cnet"):
            enc = {"fnet": "feature_encoder", "cnet": "context_encoder"}[parts[0]]
            if len(parts) == 2:
                sub = {"conv1": "convnormrelu.0", "norm1": "convnormrelu.1",
                       "conv2": "conv"}[parts[1]]
                stem = f"{enc}.{sub}"
            else:
                layer, block, mod = parts[1], parts[2], ".".join(parts[3:])
                if mod == "downsample.1":
                    continue
                sub = {"conv1": "convnormrelu1.0", "norm1": "convnormrelu1.1",
                       "conv2": "convnormrelu2.0", "norm2": "convnormrelu2.1",
                       "downsample.0": "downsample.0", "norm3": "downsample.1"}[mod]
                stem = f"{enc}.{layer}.{block}.{sub}"
        elif parts[:2] == ["update_block", "encoder"]:
            sub = {"convc1": "convcorr1", "convc2": "convcorr2", "convf1": "convflow1",
                   "convf2": "convflow2", "conv": "conv"}[parts[2]]
            stem = f"update_block.motion_encoder.{sub}.0"
        elif parts[:2] == ["update_block", "gru"]:
            stem = f"update_block.recurrent_block.convgru{parts[2][-1]}.{parts[2][:-1]}"
        elif parts[:2] == ["update_block", "mask"]:
            stem = {"0": "mask_predictor.convrelu.0", "2": "mask_predictor.conv"}[parts[2]]
        out[f"{stem}.{leaf}"] = v
    return out


@pytest.mark.parametrize("scheme", ["princeton", "torchvision"])
def test_load_torch_raft_state_dict_matches_jax(raft, scheme):
    """fabricate_raft_state_dict (princeton-vl names) and its torchvision
    renaming through both loaders: the port's module state equals JAX's
    ported params bridged, bit for bit, and both consume every tensor."""
    from test_pretrained_ports import fabricate_raft_state_dict

    from neural_jacobian_field_tpu.flow.raft import load_torch_raft_state_dict as jload
    from neural_jacobian_field_torch.flow import RAFT, load_torch_raft_state_dict

    sd = fabricate_raft_state_dict(seed=5)
    if scheme == "torchvision":
        sd = _to_torchvision(sd)
        assert not any(k.startswith(("fnet", "cnet", "module.")) for k in sd)
    j_unused, t_unused = [], []
    jparams = jload(raft["params"], sd, unused_out=j_unused)
    port = RAFT(num_iters=1, device="cpu")
    ported = load_torch_raft_state_dict(
        port, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, unused_out=t_unused)
    assert j_unused == t_unused == []
    want = from_jax_variables(jparams)
    got = port.state_dict()
    assert sorted(got) == sorted(want) and sorted(ported) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_raft_bf16_keeps_jax_float32_pins(raft):
    """dtype=bfloat16 against JAX's bf16 RAFT from the same params: float32
    flow (the pins), within 5e-2 of scale (bf16 convolutions, rounded in
    different places by XLA and PyTorch on the CPU; measured 1.8e-2)."""
    from neural_jacobian_field_tpu.flow import RAFT as JRAFT
    from neural_jacobian_field_torch.flow import RAFT

    jb = JRAFT(num_iters=ITERS, dtype=jnp.bfloat16)
    v = raft["video"]
    want = np.asarray(jax.jit(lambda a, b: jb.apply({"params": raft["params"]}, a, b,
                                                    return_low_res=True))(v[:-1], v[1:]))
    port = RAFT(num_iters=ITERS, dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(raft["port"].state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(v[:-1]), torch.from_numpy(v[1:]), return_low_res=True)
    assert got.dtype == torch.float32
    _close(got, want, 5e-2)


def test_raft_raises_without_a_card(monkeypatch):
    from neural_jacobian_field_torch.flow import RAFT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAFT(num_iters=1)
