"""The operation counts of harness/work.py at a small size, against
torch.utils.flop_counter over the plain reference; and the bounds' shape
arithmetic."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import cells, work
from portbench.harness.weights import make_weights, training
from portbench.reference import model as ref

CONFIG = json.loads((cells.ROOT / "configs" / "allegro.json").read_text())["model"]
TCONFIG = json.loads((cells.ROOT / "configs" / "allegro_transformer.json").read_text())["model"]


def _params(model):
    return make_weights(training(ref.parameter_spec(model)), 3, torch.device("cpu"))


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("backward", [False, True])
def test_encoder_flops(backward):
    p = _params(CONFIG)
    if backward:
        for k, v in p.items():
            v.requires_grad_(not ref.is_buffer(k))
    img = torch.rand(2, 64, 96, 3)

    def run():
        fine, mid, coarse = ref.encode(p, img, 4, True, ref.Precision(), {})
        if backward:
            (fine.sum() + mid.sum() + coarse.sum()).backward()

    assert _count(run) == work.encoder_flops(64, 96, 2, backward)


def test_twenty_four_stride1_convs_at_the_cells_image():
    convs = work.stride1_convs(480, 640)
    assert len(convs) == 24
    assert [c[1:4] for c in convs[:1] + convs[6:7] + convs[13:14]] == [
        (64, 64, 120), (128, 128, 60), (256, 256, 30)]


def test_trunk_flops_per_point():
    p = _params(CONFIG)
    n = 300
    z, x = torch.randn(1, n, 512), torch.randn(1, n, 63)
    mlp = CONFIG["action_decoder"]["mlp"]
    got = _count(lambda: ref.trunk(p, "decoder.density_head", mlp, z, x, ref.Precision()))
    projection = 2 * n * 512 * 128 * 3  # the plain chain projects each point's latent
    assert got == work.trunk_layer_flops(mlp, 63, 16) * n + projection


def test_transformer_flops_per_point():
    p = _params(TCONFIG)
    n = 200
    query = torch.randn(1, n, 575)
    t = TCONFIG["action_decoder"]["transformer"]
    got = _count(lambda: ref.transformer_jacobian(p, t, query, ref.Precision()))
    keys_values = t["attn_depth"] * 2 * 8 * 64 * 1024  # the embeddings' keys, once a call
    assert got == pytest.approx(work.transformer_flops(TCONFIG) * n + keys_values)


def test_step_flops_order_of_magnitude():
    gates = [False] * 5 + [True]
    per_step = work.call_flops(CONFIG, 480, 640, 7, 256, "perception", gates) / 6
    assert 1.4e12 < per_step < 1.7e12
    assert work.step_flops(CONFIG, 480, 640, 7, 256, "perception", True) > \
        work.step_flops(CONFIG, 480, 640, 7, 256, "perception", False)


def test_field_bound_is_compute_bound_at_the_cells_shapes():
    t = work.trunk_bound_s(CONFIG["action_decoder"]["mlp"], 63, 16, 384, 458752, False)
    flops = work.trunk_layer_flops(CONFIG["action_decoder"]["mlp"], 63, 16) * 458752
    assert t == pytest.approx(flops / work.PEAK_BF16_FLOPS)
