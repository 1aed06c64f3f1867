"""The 2D Jacobian-field family of the port (neural_jacobian_field_torch/
jacobian2d, train2d, the dinov2 ingest) against the JAX package's on the CPU.

Small sizes, so that JAX's compiles stay short: a UNet of depth 2 with 8
filters, a ViT of depth 2, dim 48, 3 heads on 28x28 images (a 2x2 patch
grid; a 5x5 position grid resized to it, antialiased, and a 2x2 one that is
not resized). The weights are JAX's initialisation plus seeded noise,
bridged by utils/from_jax.from_jax_params_2d. Tolerances: float64 within
1e-9 of the compared tensor's scale (both sides compute the same float64
operations in other orders), float32 within 1e-5. The UNet casts its output
to float32, as JAX's does, so its float64 forward is compared at the input
of that cast (conv_final's output, Flax's captured intermediate); the
gradients flow through the cast in float64 on both sides.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as ftu
from neural_jacobian_field_torch.utils.from_jax import from_jax_params_2d, params_2d_flat

F64, F32 = 1e-9, 1e-5
VIT = dict(depth=2, dim=48, heads=3)


def _rel(got, want):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _tol(dtype):
    return F64 if dtype == np.float64 else F32


def _noisy(params, dtype, seed=0, scale=0.05):
    """JAX's initial params plus seeded noise, in dtype (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float64)
                                   + scale * rng.normal(size=a.shape)).astype(dtype), params)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in ftu.flatten_dict(tree).items()}


def _port_grads(module, names=None):
    return {n: p.grad.detach().numpy() for n, p in module.named_parameters()
            if p.grad is not None and (names is None or n in names)}


def _check_grads(port_module, jax_grads, dtype):
    """Every parameter's gradient: the port's against JAX's bridged ones."""
    want = from_jax_params_2d(jax.tree.map(np.asarray, jax_grads))
    got = _port_grads(port_module)
    assert set(got) == set(want)
    for n in want:
        assert _rel(got[n], want[n].numpy()) <= _tol(dtype), n


# ------------------------------------------------------------------ modules


def test_upconv_bridge_float64():
    """Flax's ConvTranspose (unflipped kernel over the dilated input) against
    the port's ConvTranspose2d with the bridged (flipped) kernel, inside
    UpConv, on an input with no symmetry: forward and every gradient in
    float64."""
    from neural_jacobian_field_tpu.jacobian2d import unet as ju

    from neural_jacobian_field_torch.jacobian2d import unet as tu

    rng = np.random.default_rng(1)
    down = rng.normal(size=(2, 6, 10, 4))
    up = rng.normal(size=(2, 3, 5, 8))
    g = rng.normal(size=(2, 6, 10, 4))
    with jax.enable_x64(True):
        m = ju.UpConv(out_channels=4)
        params = _noisy(m.init(jax.random.PRNGKey(0), jnp.asarray(down), jnp.asarray(up))
                        ["params"], np.float64)

        def f(p, a, b):
            return jnp.sum(m.apply({"params": p}, a, b) * g)

        want = m.apply({"params": params}, jnp.asarray(down), jnp.asarray(up))
        gp, ga, gb = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(down), jnp.asarray(up))
    t = tu.UpConv(8, 4).double()
    t.load_state_dict(from_jax_params_2d(params), strict=True)
    a, b = (torch.from_numpy(v).requires_grad_(True) for v in (down, up))
    out = t(a, b)
    assert _rel(out, want) <= F64
    (out * torch.from_numpy(g)).sum().backward()
    assert _rel(a.grad, ga) <= F64 and _rel(b.grad, gb) <= F64
    _check_grads(t, gp, np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_unet_against_jax(dtype):
    """UNet (depth 2, 8 filters): the output (float64: conv_final's, before
    the float32 cast), the bottleneck features and every parameter's
    gradient."""
    from neural_jacobian_field_tpu.jacobian2d import unet as ju

    from neural_jacobian_field_torch.jacobian2d import unet as tu

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 12, 3)).astype(dtype)
    g = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
    with jax.enable_x64(dtype == np.float64):
        m = ju.UNet(out_channels=4, depth=2, start_filts=8)
        params = _noisy(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], dtype)
        out, inter = m.apply({"params": params}, jnp.asarray(x), capture_intermediates=True,
                             mutable=["intermediates"])
        pre = np.asarray(inter["intermediates"]["conv_final"]["__call__"][0])
        _, feats = m.apply({"params": params}, jnp.asarray(x), return_features=True)
        gp = jax.grad(lambda p: jnp.sum(m.apply({"params": p}, jnp.asarray(x)) * g))(params)
    t = tu.UNet(3, 4, depth=2, start_filts=8).to(torch.float64 if dtype == np.float64
                                                  else torch.float32)
    t.load_state_dict(from_jax_params_2d(params), strict=True)
    caught = {}
    t.conv_final.register_forward_hook(lambda mod, i, o: caught.setdefault("pre", o))
    got = t(torch.from_numpy(x))
    assert got.dtype == torch.float32 and np.asarray(out).dtype == np.float32
    assert _rel(caught["pre"], pre) <= _tol(dtype)
    assert _rel(got, out) <= F32
    assert _rel(t(torch.from_numpy(x), return_features=True)[1], feats) <= F32
    (got * torch.from_numpy(g)).sum().backward()
    _check_grads(t, gp, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pos_grid", [5, 2])
def test_vit_against_jax(dtype, pos_grid):
    """ViT (depth 2, dim 48, 3 heads, 28x28: a 2x2 patch grid): the patch
    tokens and every parameter's gradient; pos_grid 5 takes the antialiased
    bilinear resize of the position embeddings to 2x2, pos_grid 2 none."""
    from neural_jacobian_field_tpu.jacobian2d import vit as jv

    from neural_jacobian_field_torch.jacobian2d import vit as tv

    rng = np.random.default_rng(3)
    img = rng.uniform(size=(2, 28, 28, 3)).astype(dtype)
    g = rng.normal(size=(2, 4, 48)).astype(np.float32)
    with jax.enable_x64(dtype == np.float64):
        m = jv.ViTS14(cfg=jv.ViTCfg(pos_grid=pos_grid, **VIT))
        params = _noisy(m.init(jax.random.PRNGKey(1), jnp.asarray(img))["params"], dtype)
        want = m.apply({"params": params}, jnp.asarray(img))
        gp = jax.grad(lambda p: jnp.sum(m.apply({"params": p}, jnp.asarray(img)) * g))(params)
    t = tv.ViTS14(tv.ViTCfg(pos_grid=pos_grid, **VIT))
    t = t.to(torch.float64 if dtype == np.float64 else torch.float32)
    t.load_state_dict(from_jax_params_2d(params), strict=True)
    got = t(torch.from_numpy(img))
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    assert _rel(got, want) <= _tol(dtype)
    (got * torch.from_numpy(g).to(got.dtype)).sum().backward()
    _check_grads(t, gp, dtype)


def _jax_model(name, command_dim=2):
    from neural_jacobian_field_tpu.jacobian2d import models as jm
    from neural_jacobian_field_tpu.jacobian2d.vit import ViTCfg

    if name == "unet":
        return jm.UnetJacobianField(cfg=jm.UnetJacobianFieldCfg(
            depth=2, start_filts=8, command_dim=command_dim))
    return jm.TransformerJacobianField(cfg=jm.TransformerJacobianFieldCfg(
        vit=ViTCfg(pos_grid=5, **VIT), decoder_depth=2, command_dim=command_dim))


def _port_model(name, command_dim=2):
    from neural_jacobian_field_torch.jacobian2d import models as tm
    from neural_jacobian_field_torch.jacobian2d.vit import ViTCfg

    if name == "unet":
        return tm.UnetJacobianField(tm.UnetJacobianFieldCfg(
            depth=2, start_filts=8, command_dim=command_dim))
    return tm.TransformerJacobianField(tm.TransformerJacobianFieldCfg(
        vit=ViTCfg(pos_grid=5, **VIT), decoder_depth=2, command_dim=command_dim))


def _batch(seed=4, b=2, hw=28, command_dim=2):
    rng = np.random.default_rng(seed)
    return {"input_frame_curr": rng.uniform(size=(b, hw, hw, 3)),
            "input_command": rng.normal(size=(b, command_dim)),
            "trgt_flow_curr": rng.normal(size=(b, hw, hw, 2))}


@pytest.mark.parametrize("name", ["unet", "transformer"])
def test_models_against_jax(name):
    """Both Jacobian fields in float64: the Jacobian map and the flow (within
    the UNet's float32 output rounding: 1e-6 of scale), every gradient of
    the flow loss within 1e-9, and no gradient at all on the ViT (JAX's
    stop_gradient: its gradients are exactly zero)."""
    batch = _batch()
    with jax.enable_x64(True):
        jmodel = _jax_model(name)
        img, cmd = jnp.asarray(batch["input_frame_curr"]), jnp.asarray(batch["input_command"])
        params = _noisy(jmodel.init(jax.random.PRNGKey(0), img, cmd)["params"], np.float64)
        out = jmodel.apply({"params": params}, img, cmd)
        flow = batch["trgt_flow_curr"]

        def loss(p):
            return jnp.mean((jmodel.apply({"params": p}, img, cmd).flow - flow) ** 2)

        gp = jax.grad(loss)(params)
    t = _port_model(name).double()
    t.load_state_dict(from_jax_params_2d(params), strict=True)
    got = t(torch.from_numpy(batch["input_frame_curr"]), torch.from_numpy(batch["input_command"]))
    assert _rel(got.jacobian, out.jacobian) <= 1e-6 and _rel(got.flow, out.flow) <= 1e-6
    torch.mean((got.flow - torch.from_numpy(flow)) ** 2).backward()
    grads = _port_grads(t)
    want = from_jax_params_2d(jax.tree.map(np.asarray, gp))
    for n, w in want.items():
        if n.startswith("dino."):
            assert not np.asarray(w).any() and n not in grads
        else:
            assert _rel(grads[n], w.numpy()) <= F64, n


def test_compute_sensitivity_bit_for_bit():
    """compute_sensitivity (norms, min-max over the image, the 1e-10 and the
    clip) equal to JAX's bit for bit on float32 arrays, a constant channel
    included."""
    from neural_jacobian_field_tpu.jacobian2d.models import compute_sensitivity as jcs

    from neural_jacobian_field_torch.jacobian2d.models import compute_sensitivity

    rng = np.random.default_rng(5)
    j = rng.normal(size=(3, 9, 11, 6)).astype(np.float32)
    j[1, ..., 2:4] = 0.25  # a constant command channel: 0 / 1e-10
    got = compute_sensitivity(torch.from_numpy(j)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs(jnp.asarray(j))))


# ----------------------------------------------------------------- training


@pytest.mark.parametrize("name", ["unet", "transformer"])
def test_train_steps_against_optax(name):
    """Three steps of the port's make_train_step_2d against JAX's (optax's
    add_decayed_weights, scale_by_adam, the linear warm-up; the dino mask)
    from the same float64 params: losses and parameters within 1e-9 of
    scale after each step; the ViT bit for bit as it was."""
    from neural_jacobian_field_tpu.jacobian2d import train as jt

    from neural_jacobian_field_torch.jacobian2d import train as tt

    batches = [_batch(seed=10 + i) for i in range(3)]
    cfg = dict(lr=1e-3, weight_decay=1e-2, warm_up_steps=2)
    with jax.enable_x64(True):
        jmodel = _jax_model(name)
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        st = jt.create_train_state_2d(jax.random.PRNGKey(0), jmodel, jb[0], jt.Train2DCfg(**cfg))
        params = jax.tree.map(jnp.asarray, _noisy(st.params, np.float64))
        tx = jt.make_optimizer_2d(jt.Train2DCfg(**cfg), params)
        st = st.replace(params=params, opt_state=tx.init(params))
        step = jt.make_train_step_2d(jmodel, jt.Train2DCfg(**cfg), donate=False)
        jax_runs = []
        for b in jb:
            st, m = step(st, b)
            jax_runs.append((float(m["train/loss"]), _flat(jax.tree.map(np.asarray, st.params))))
    t = _port_model(name).double()
    t.load_state_dict(from_jax_params_2d(params), strict=True)
    dino0 = {k: v.clone() for k, v in t.state_dict().items() if k.startswith("dino.")}
    state = tt.create_train_state_2d(t, tt.Train2DCfg(**cfg))
    pstep = tt.make_train_step_2d(t, tt.Train2DCfg(**cfg))
    assert (name == "transformer") == bool(state.frozen)
    for b, (loss, want) in zip(batches, jax_runs):
        got = pstep(state, b)["train/loss"]
        assert abs(float(got) - loss) <= F64 * abs(loss)
        port = from_jax_params_2d(want)
        for n, p in t.state_dict().items():
            assert _rel(p, port[n].numpy()) <= F64, n
    assert all(torch.equal(v, t.state_dict()[k]) for k, v in dino0.items())
    assert state.step == 3


def test_control_step_against_jax():
    """The damped least-squares command from the Jacobian at tracked pixels,
    some of them not visible, within 1e-9 of scale (float64)."""
    from neural_jacobian_field_tpu.jacobian2d.control import control_step as jcontrol

    from neural_jacobian_field_torch.jacobian2d import control_step

    rng = np.random.default_rng(6)
    img = rng.uniform(size=(1, 28, 28, 3))
    yx = rng.integers(0, 28, size=(12, 2))
    desired = rng.normal(size=(12, 2))
    visible = (rng.uniform(size=12) > 0.3).astype(np.float64)
    with jax.enable_x64(True):
        jmodel = _jax_model("unet")
        params = _noisy(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.zeros((1, 2)))
                        ["params"], np.float64)
        want = np.asarray(jcontrol(jmodel, {"params": params}, jnp.asarray(img),
                                   jnp.asarray(yx), jnp.asarray(desired), jnp.asarray(visible),
                                   damping=1e-3))
    t = _port_model("unet").double()
    t.load_state_dict(from_jax_params_2d(params), strict=True)
    got = control_step(t, torch.from_numpy(img), torch.from_numpy(yx),
                       torch.from_numpy(desired), torch.from_numpy(visible), damping=1e-3)
    assert got.shape == (2,) and _rel(got, want) <= F64


# ------------------------------------------------------------ data and files


@pytest.mark.parametrize("scene,command_dim", [("pusher", 2), ("planar_hand", 4)])
def test_dataset_bit_for_bit(tmp_path, scene, command_dim):
    """make_synthetic_trajectories writes JAX's arrays for the same seed; a
    training item with the same draw of the frame (random.seed(s) for JAX's
    global random, random.Random(s) for the port's), a validation item and a
    collated batch are JAX's bit for bit; resized items (JAX's
    jax.image.resize against the port's antialiased interpolate) within
    1e-5 of scale."""
    from neural_jacobian_field_tpu.jacobian2d import dataset as jd

    from neural_jacobian_field_torch.jacobian2d import dataset as td

    kw = dict(num_trajs=3, num_steps=5, height=24, width=32, seed=7, scene=scene)
    jd.make_synthetic_trajectories(tmp_path / "j", **kw)
    td.make_synthetic_trajectories(tmp_path / "t", **kw)
    for f in sorted((tmp_path / "j" / "train").glob("*.pkl")):
        a, b = jd.load_gzip_file(f), td.load_gzip_file(tmp_path / "t" / "train" / f.name)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    name = "pusher" if scene == "pusher" else "planar_hand"
    jds = jd.Dataset2D(jd.Dataset2DCfg(name=name, root=tmp_path / "j", command_dim=command_dim))
    tds = td.Dataset2D(td.Dataset2DCfg(name=name, root=tmp_path / "t", command_dim=command_dim),
                       rng=random.Random(3))
    random.seed(3)
    items = [(jds[i], tds[i]) for i in (0, 2, 1, 2)]
    for a, b in items:
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    ja, ta = jds.get_val_item(1), tds.get_val_item(1)
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k])
    cj, ct = jd.collate_2d([a for a, _ in items]), td.collate_2d([b for _, b in items])
    for k in cj:
        np.testing.assert_array_equal(cj[k], ct[k])
    jr = jd.Dataset2D(jd.Dataset2DCfg(name=name, root=tmp_path / "j", command_dim=command_dim,
                                      resize_hw=(12, 20))).get_val_item(0)
    tr = td.Dataset2D(td.Dataset2DCfg(name=name, root=tmp_path / "t", command_dim=command_dim,
                                      resize_hw=(12, 20))).get_val_item(0)
    for k in ("input_video_sequence", "trgt_flow_sequence"):
        assert tr[k].shape == jr[k].shape and _rel(tr[k], jr[k]) <= F32
    np.testing.assert_array_equal(tr["input_command_sequence"], jr["input_command_sequence"])


@pytest.mark.parametrize("name", ["unet", "transformer"])
def test_npz_keys_shapes_and_both_ways(tmp_path, name):
    """params_2d_flat: the .npz key set and shapes of JAX's train2d for the
    same config; a port-written .npz applied by JAX gives the port's
    outputs, a JAX-written one loaded by the port (train2d.load_params_2d)
    JAX's (float32, 1e-5)."""
    from neural_jacobian_field_torch.train2d import load_params_2d

    batch = _batch()
    img, cmd = batch["input_frame_curr"].astype(np.float32), batch["input_command"].astype(
        np.float32)
    jmodel = _jax_model(name)
    jparams = _noisy(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(cmd))
                     ["params"], np.float32)
    jflat = _flat(jparams)
    t = _port_model(name).init_weights(torch.Generator().manual_seed(0))
    flat = params_2d_flat(t)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in jflat.items()}
    np.savez(tmp_path / "port.npz", **flat)
    with np.load(tmp_path / "port.npz") as f:
        tree = ftu.unflatten_dict({tuple(k.split("/")): f[k] for k in f.files})
    want = t(torch.from_numpy(img), torch.from_numpy(cmd))
    got = jmodel.apply({"params": tree}, jnp.asarray(img), jnp.asarray(cmd))
    assert _rel(want.flow, got.flow) <= F32 and _rel(want.jacobian, got.jacobian) <= F32
    np.savez(tmp_path / "jax.npz", **jflat)
    t2 = load_params_2d(_port_model(name), tmp_path / "jax.npz")
    got = t2(torch.from_numpy(img), torch.from_numpy(cmd))
    want = jmodel.apply({"params": jparams}, jnp.asarray(img), jnp.asarray(cmd))
    assert _rel(got.flow, want.flow) <= F32


@pytest.mark.parametrize("form", ["yaml", "legacy"])
def test_train2d_cli_forms(tmp_path, form):
    """python -m neural_jacobian_field_torch.train2d on the CPU in both
    forms: synthetic 64x64 trajectories written, 3 steps of the pusher UNet
    logged with a finite loss, the .npz with JAX's keys (the default
    configuration's UNet) loadable into the model."""
    from neural_jacobian_field_tpu.jacobian2d import models as jm

    from neural_jacobian_field_torch import train2d

    root, out = tmp_path / "data", tmp_path / "params.npz"
    if form == "yaml":
        argv = ["--device", "cpu", "dataset=pusher_only", "wrapper=pusher_only",
                f"dataset.root={root}", "training.max_steps=3", "training.data.batch_size=2",
                f"checkpoint.out={out}", "make_synthetic=true"]
    else:
        argv = ["--root", str(root), "--steps", "3", "--batch-size", "2", "--make-synthetic",
                "--out", str(out), "--device=cpu"]
    lines = []
    state, path = train2d.main(argv, log=lines.append)
    assert path == out and len(list((root / "train").glob("*.pkl"))) == 16
    assert state.step == 3 and any(line.startswith("step 3: loss=") for line in lines)
    loss = float(next(line for line in lines if line.startswith("step 3")).split("=")[1].split()[0])
    assert np.isfinite(loss)
    shapes = jax.eval_shape(jm.UnetJacobianField(cfg=jm.UnetJacobianFieldCfg()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)))
    want = {"/".join(k): v.shape for k, v in ftu.flatten_dict(shapes["params"]).items()}
    with np.load(out) as f:
        assert {k: f[k].shape for k in f.files} == want
    train2d.load_params_2d(_port_model("unet").__class__(), out)


def _hub_state_dict(cfg, seed=8):
    """A fabricated torch.hub dinov2_vits14 state dict (its names and
    shapes, seeded values, mask_token and a stray tensor beside)."""
    rng = np.random.default_rng(seed)
    d, hid, p = cfg.dim, int(cfg.dim * cfg.mlp_ratio), cfg.patch_size

    def r(*shape):
        return torch.from_numpy(rng.normal(scale=0.05, size=shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": r(d, 3, p, p), "patch_embed.proj.bias": r(d),
          "cls_token": r(1, 1, d), "pos_embed": r(1, cfg.pos_grid ** 2 + 1, d),
          "mask_token": r(1, d), "norm.weight": 1 + r(d), "norm.bias": r(d),
          "stray.tensor": r(3)}
    for i in range(cfg.depth):
        q = f"blocks.{i}"
        for name, shape in (("norm1", (d,)), ("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("norm2", (d,)), ("mlp.fc1", (hid, d)), ("mlp.fc2", (d, hid))):
            sd[f"{q}.{name}.weight"] = r(*shape)
            sd[f"{q}.{name}.bias"] = r(shape[0])
        sd[f"{q}.ls1.gamma"], sd[f"{q}.ls2.gamma"] = r(d), r(d)
    return sd


def test_dinov2_ingest_against_jax(tmp_path):
    """The ingest CLI's dinov2 kind on a fabricated ViT-S/14 hub state dict:
    its state equals JAX's load_torch_dinov2_state_dict through the bridge
    bit for bit, the report's keys and counts are JAX's (every ViT leaf
    overwritten, the stray tensor unused), and --eval runs the ViT on the
    56x56 fixture."""
    from neural_jacobian_field_tpu.jacobian2d import vit as jv

    from neural_jacobian_field_torch import ingest

    sd = _hub_state_dict(jv.ViTCfg())
    path = tmp_path / "dinov2.pth"
    torch.save(sd, path)
    shapes = jax.eval_shape(jv.ViTS14().init, jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))
    unused = []
    jparams = jv.load_torch_dinov2_state_dict(shapes["params"], {k: v.numpy() for k, v in
                                                                 sd.items()},
                                              unused_out=unused)
    want = from_jax_params_2d(jparams)
    code = ingest.main([str(path), "--device", "cpu", "--eval", "--out",
                        str(tmp_path / "vit.pt")])
    assert code == 0
    saved = torch.load(tmp_path / "vit.pt", weights_only=True)
    assert set(saved) == set(want)
    assert all(torch.equal(saved[k], want[k]) for k in want)
    assert unused == ["stray.tensor"]


def test_dinov2_ingest_report(tmp_path, capsys):
    """The report line: JAX's keys, the counts of a full ViT-S/14."""
    import json

    from neural_jacobian_field_tpu.jacobian2d import vit as jv

    from neural_jacobian_field_torch import ingest

    path = tmp_path / "dinov2.pth"
    torch.save(_hub_state_dict(jv.ViTCfg()), path)
    assert ingest.main([str(path), "--device", "cpu", "--eval"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["kind"] == "dinov2" and report["out"] == str(path) + ".torch.pt"
    assert (report["consumed"], report["unused"], report["total_leaves"]) == (
        6 + 12 * 14 + 1, 1, 6 + 12 * 14)
    assert report["overwritten"] == report["total_leaves"]
    assert report["unused_keys"] == ["stray.tensor"]
    assert report["eval"]["finite"] and report["eval"]["tokens"] == [1, 16, 384]
