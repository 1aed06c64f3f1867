"""The 2D Jacobian-field family (PyTorch counterpart of the JAX package's
jacobian2d/, the reference's `jacobian` package and tutorials 1-3): UNet and
ViT-S/14 (DINOv2) Jacobian fields, their datasets and synthetic
trajectories, the train step, least-squares control and visualisation."""

from .control import control_step
from .dataset import (
    Dataset2D,
    Dataset2DCfg,
    collate_2d,
    load_gzip_file,
    make_synthetic_trajectories,
    save_gzip_file,
)
from .models import (
    MODELS_2D,
    JacobianFieldCfg,
    JacobianNetOutput,
    TransformerJacobianField,
    TransformerJacobianFieldCfg,
    UnetJacobianField,
    UnetJacobianFieldCfg,
    compute_sensitivity,
    get_model,
    predict_2d,
)
from .train import Train2DCfg, TrainState2D, create_train_state_2d, make_train_step_2d
from .unet import UNet
from .visualize import create_video_grid, flow_video, visualize_model, visualize_sensitivity
from .vit import ViTCfg, ViTS14, load_torch_dinov2_state_dict
