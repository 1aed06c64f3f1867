"""The training pipeline's configuration (PyTorch counterpart of
config/common.py): nested frozen dataclasses with the JAX package's field
names and defaults, built from configurations/ by config/tools.py."""

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..data.dataset import DatasetCfgCommon
from ..models.model import ModelCfg
from ..training.losses import LossCfg

# the repo's configuration tree, read as data
CONFIG_DIR = Path(__file__).resolve().parent.parent.parent / "configurations"


@dataclass(frozen=True)
class WandbCfg:
    name: str = "jacobian_fields"
    entity: Optional[str] = None
    project: str = "self-model"
    mode: str = "disabled"  # online | offline | disabled
    group: Optional[str] = None
    tags: Optional[tuple] = None


@dataclass(frozen=True)
class DataLoaderCfg:
    batch_size: int = 7
    num_workers: int = 2
    rays_per_batch: Optional[int] = 256


@dataclass(frozen=True)
class OptimCfg:
    lr: float = 1e-4
    warm_up_steps: int = 10000
    weight_decay: float = 1e-5
    grad_clip_norm: Optional[float] = None  # global-norm clipping ahead of Adam
    encoder_lr_scale: float = 1.0  # stage-1 lr multiplier on the encoder


@dataclass(frozen=True)
class TrainingCfg:
    data: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    optim: OptimCfg = field(default_factory=OptimCfg)
    val_check_interval: int = 1000
    max_steps: int = 50_000_000
    loss: LossCfg = field(default_factory=LossCfg)
    compute_dtype: Optional[str] = None  # "bfloat16" for the encoder and the trunks
    steps_per_call: int = 1  # train steps per captured program


@dataclass(frozen=True)
class ValidationVideoCfg:
    frequency: float = 0.25
    num_frames: int = 30
    frame_rate: int = 30


@dataclass(frozen=True)
class ValidationCfg:
    data: DataLoaderCfg = field(default_factory=lambda: DataLoaderCfg(
        batch_size=1, num_workers=1, rays_per_batch=None))
    video: ValidationVideoCfg = field(default_factory=ValidationVideoCfg)


@dataclass(frozen=True)
class CheckpointCfg:
    every_n_train_steps: int = 5000
    load: Optional[str] = None
    dir: Path = Path("checkpoints")


@dataclass(frozen=True)
class PipelineCfg:
    dataset: DatasetCfgCommon = field(default_factory=DatasetCfgCommon)
    model: ModelCfg = field(default_factory=ModelCfg)
    wandb: WandbCfg = field(default_factory=WandbCfg)
    training: TrainingCfg = field(default_factory=TrainingCfg)
    validation: ValidationCfg = field(default_factory=ValidationCfg)
    checkpoint: CheckpointCfg = field(default_factory=CheckpointCfg)
    seed: int = 0


def get_typed_root_config(cfg_dict) -> PipelineCfg:
    from .tools import from_dict

    return from_dict(PipelineCfg, cfg_dict)
