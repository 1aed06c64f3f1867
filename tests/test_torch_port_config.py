"""The port's configuration against the JAX package's: load_config's dicts
equal to JAX's for the override sets the repo documents (the defaults, the
e2e drive's, the toy arm's, stage 2, a checkpoint warm start), for every
group file of configurations/ and configurations2d/ and for dotted
override values of each YAML form; the typed configs equal field by
field, and every key the YAMLs set carried by a field. Exact equality
throughout."""

import dataclasses
from pathlib import Path

import pytest

from neural_jacobian_field_torch.config import (
    CONFIG_DIR, get_typed_root_config, load_config)

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(REPO)) for d in ("configurations", "configurations2d")
               for p in (REPO / d).rglob("*.yaml"))

OVERRIDE_SETS = {
    "default": [],
    "e2e": ["dataset.root=/data/scene", "dataset.num_total_joints=4",
            "dataset.disabled_joints=null", "dataset.max_num_frames_per_traj=4",
            "model.action_dim=4", "model.rendering.num_proposal_samples=[8]",
            "model.rendering.num_nerf_samples=8", "model.encoder.num_layers=2",
            "model.encoder.norm_type=batch"],
    "toy_arm": ["dataset=dataset_toy_arm", "model=model_toy_arm",
                "dataset.root=/data/toy_arm"],
    "action": ["dataset=dataset_allegro", "model=model_allegro", "dataset.root=/data/allegro",
               "dataset.mode=action", "training.steps_per_call=6",
               "training.compute_dtype=bfloat16"],
    "checkpoint_load": ["dataset.mode=action", "checkpoint.load=checkpoints/perception",
                        "checkpoint.dir=/tmp/ck", "training.optim.lr=1e-4",
                        "dataset.action_supervision_type=tracks",
                        "dataset.num_positive_samples=24", "training.val_check_interval=0"],
    "transformer": ["model=model_allegro_transformer"],
    "flow_mlp": ["model.action_decoder.name=flow_mlp"],
}


def test_yaml_files_found():
    assert len(YAMLS) >= 12 and "configurations/config.yaml" in YAMLS


def _jax_load(config_dir, overrides):
    from neural_jacobian_field_tpu.config import load_config as jload

    return jload(config_dir, overrides)


GROUP_CHOICES = [(d.stem, m.stem) for d in sorted((REPO / "configurations/dataset").glob("*.yaml"))
                 for m in sorted((REPO / "configurations/model").glob("*.yaml"))]


@pytest.mark.parametrize("dataset,model", GROUP_CHOICES)
def test_every_group_choice_matches_jax(dataset, model):
    """Every dataset x model group file of configurations/: the dict, and
    the typed config field by field."""
    from neural_jacobian_field_tpu.config import get_typed_root_config as jtyped

    ov = [f"dataset={dataset}", f"model={model}"]
    got = load_config(CONFIG_DIR, ov)
    want = _jax_load(CONFIG_DIR, ov)
    assert got == want
    assert _as_plain(get_typed_root_config(got)) == _as_plain(jtyped(want))


@pytest.mark.parametrize("dataset,wrapper", [
    (d.stem, w.stem) for d in sorted((REPO / "configurations2d/dataset").glob("*.yaml"))
    for w in sorted((REPO / "configurations2d/wrapper").glob("*.yaml"))])
def test_configurations2d_dicts_match_jax(dataset, wrapper):
    """The loader on the 2-D tree's groups (dicts only: its typed config is
    not the port's)."""
    d2 = REPO / "configurations2d"
    ov = [f"dataset={dataset}", f"wrapper={wrapper}"]
    assert load_config(d2, ov) == _jax_load(d2, ov)


@pytest.mark.parametrize("override", [
    "training.optim.lr=1e-4", "training.optim.lr=0.5", "training.max_steps=1_000",
    "model.rendering.num_proposal_samples=[8, 16]", "dataset.disabled_joints=null",
    "dataset.disabled_joints=[]", "training.val_check_interval=~", "wandb.mode=online",
    "wandb.name='a b'", 'wandb.group="x#y"', "dataset.augment_ctxt_image=true",
    "dataset.augment_ctxt_image=False", "dataset.root=/data/scene", "new.key.path=3",
])
def test_dotted_override_values_match_jax(override):
    """A dotted override's value is read as YAML, as JAX's loader reads it."""
    assert load_config(CONFIG_DIR, [override]) == _jax_load(CONFIG_DIR, [override])


def _jax_dict(overrides):
    from neural_jacobian_field_tpu.config import load_config as jload
    from neural_jacobian_field_tpu.train import CONFIG_DIR as JDIR

    return jload(JDIR, overrides)


def test_config_dir_is_the_repos():
    from neural_jacobian_field_tpu.train import CONFIG_DIR as JDIR

    assert CONFIG_DIR.resolve() == JDIR.resolve() == (REPO / "configurations").resolve()


@pytest.mark.parametrize("name", list(OVERRIDE_SETS))
def test_load_config_matches_jax(name):
    assert load_config(CONFIG_DIR, OVERRIDE_SETS[name]) == _jax_dict(OVERRIDE_SETS[name])


def _as_plain(x):
    if dataclasses.is_dataclass(x):
        return {"__type__": type(x).__name__,
                **{f.name: _as_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return [type(x).__name__] + [_as_plain(v) for v in x]
    if isinstance(x, Path):
        return ("Path", str(x))
    return x


@pytest.mark.parametrize("name", [n for n in OVERRIDE_SETS])
def test_typed_config_matches_jax(name):
    from neural_jacobian_field_tpu.config import get_typed_root_config as jtyped

    ov = OVERRIDE_SETS[name]
    got = get_typed_root_config(load_config(CONFIG_DIR, ov))
    want = jtyped(_jax_dict(ov))
    assert _as_plain(got) == _as_plain(want)


def _keys(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _keys(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


@pytest.mark.parametrize("name", ["default", "toy_arm", "transformer"])
def test_typed_config_carries_every_yaml_key(name):
    raw = load_config(CONFIG_DIR, OVERRIDE_SETS[name])
    cfg = get_typed_root_config(raw)
    for key in _keys(raw):
        node = cfg
        for part in key.split("."):
            assert hasattr(node, part), key
            node = getattr(node, part)
    assert cfg.training.optim.lr == 1e-4 and isinstance(cfg.training.optim.lr, float)
    assert isinstance(cfg.dataset.root, Path)


def test_override_values_are_typed():
    cfg = get_typed_root_config(load_config(CONFIG_DIR, OVERRIDE_SETS["e2e"]))
    assert cfg.model.rendering.num_proposal_samples == (8,)
    assert cfg.dataset.disabled_joints is None and cfg.model.encoder.num_layers == 2
    cfg = get_typed_root_config(load_config(CONFIG_DIR, OVERRIDE_SETS["checkpoint_load"]))
    assert cfg.checkpoint.load == "checkpoints/perception" and cfg.checkpoint.dir == Path("/tmp/ck")
    with pytest.raises(KeyError):
        get_typed_root_config(load_config(CONFIG_DIR, ["training.no_such_key=1"]))


def test_transformer_decoder_reaches_the_ports_not_implemented():
    """model_allegro_transformer.yaml is a valid configuration, and the port
    builds its model: the transformer decoder at the YAML's widths (the name
    is kept from when the port raised here). So does the flow-MLP decoder
    chosen by `model.action_decoder.name=flow_mlp`."""
    from neural_jacobian_field_torch.models.decoders import (
        ActionDecoderFlowMlp, ActionDecoderJacobianTransformer)
    from neural_jacobian_field_torch.models.model import Model

    cfg = get_typed_root_config(load_config(CONFIG_DIR, OVERRIDE_SETS["transformer"]))
    assert cfg.model.action_decoder.name == "jacobian_transformer"
    assert cfg.model.action_decoder.transformer.num_attn_heads == 8
    model = Model(cfg.model)
    assert isinstance(model.decoder, ActionDecoderJacobianTransformer)
    assert model.decoder.jacobian_index_embedding.shape == (1, 8, 64)
    assert model.decoder.jacobian_attn_decoder.layers_2_attn.to_q.weight.shape == (512, 64)
    cfg = get_typed_root_config(load_config(CONFIG_DIR, OVERRIDE_SETS["flow_mlp"]))
    assert isinstance(Model(cfg.model).decoder, ActionDecoderFlowMlp)
