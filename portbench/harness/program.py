"""The program under test, built from a configuration file: the port's model
configuration from the file's "model" group, the model made on the device
with the benchmark's own seeded weights loaded into it."""

import dataclasses

SEED_STREAMS = {"weights": 1, "inputs": 2, "sample": 4, "statistics": 5}


def sub_seed(seed: int, stream: str) -> int:
    """A generator seed of its own for each stream of a run's randomness."""
    return (seed * 8191 + SEED_STREAMS[stream]) % (2 ** 63 - 1)


def _build(cls, values: dict, nested: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if f.name in nested:
            v = nested[f.name](v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def model_cfg(model: dict):
    """The port's ModelCfg of a configuration's "model" group."""
    from neural_jacobian_field_torch.models.decoders import (
        DECODERS, DensityDecoderMlpCfg, TransformerCfg)
    from neural_jacobian_field_torch.models.encoder_resnet import EncoderResnetCfg
    from neural_jacobian_field_torch.models.model import ModelCfg, RenderingCfg
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    def mlp(v):
        return _build(MlpCfg, v, {})

    act = model["action_decoder"]
    act_cls = DECODERS[act["name"]][0]
    nested = {"mlp": mlp, "transformer": lambda v: _build(TransformerCfg, v, {})}
    return _build(ModelCfg, model, {
        "rendering": lambda v: _build(RenderingCfg, v, {}),
        "encoder": lambda v: _build(EncoderResnetCfg, v, {}),
        "density_decoder": lambda v: _build(DensityDecoderMlpCfg, v, {"mlp": mlp}),
        "action_decoder": lambda v: _build(act_cls, v, nested),
    })


def build_model(config: dict, weights: dict, device):
    """The port's Model of the configuration on `device`, computing in the
    configuration's dtype, holding `weights` (every parameter and buffer)."""
    import torch

    from neural_jacobian_field_torch.models.model import Model

    dtype = getattr(torch, config["dtype"])
    with torch.device(device):
        model = Model(model_cfg(config["model"]),
                      compute_dtype=None if dtype == torch.float32 else dtype)
    model.load_state_dict(weights, strict=True)
    return model


def synchronize(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak_bytes(device) -> int:
    """The most memory the process has held on the device (0 on the CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
