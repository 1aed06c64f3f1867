"""The 2D pipeline's typed configuration (PyTorch counterpart of
jacobian2d/config.py): the reference's jacobian/config schema on the port's
YAML-group / dotted-override machinery (config/tools.py), read from the
repository's configurations2d/ in place.

  python -m neural_jacobian_field_torch.train2d \\
      dataset=pusher_only wrapper=pusher_only dataset.root=... \\
      training.max_steps=2000
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Union

from ..config.common import WandbCfg
from .models import TransformerJacobianFieldCfg, UnetJacobianFieldCfg

# the repository's 2D configuration tree, read as data
CONFIG2D_DIR = Path(__file__).resolve().parent.parent.parent / "configurations2d"


@dataclass(frozen=True)
class Optim2DCfg:
    """wrapper/*.yaml's optim group."""

    lr: float = 1e-4
    warm_up_steps: int = 10000
    weight_decay: float = 1e-5


@dataclass(frozen=True)
class Wrapper2DCfg:
    """`name` picks the training wrapper (pusher | planar_hand); `model` is
    the name-tagged Jacobian-field union."""

    name: str = "pusher"
    optim: Optim2DCfg = field(default_factory=Optim2DCfg)
    model: Union[UnetJacobianFieldCfg, TransformerJacobianFieldCfg] = field(
        default_factory=UnetJacobianFieldCfg)


@dataclass(frozen=True)
class Dataset2DGroupCfg:
    """dataset/*.yaml."""

    name: str = "pusher"
    root: Path = Path("/tmp/njf_2d_data")
    command_dim: int = 2
    action_scale: float = 4.0
    new_H: Optional[int] = None
    new_W: Optional[int] = None


@dataclass(frozen=True)
class DataLoader2DCfg:
    batch_size: int = 12
    num_workers: int = 2


@dataclass(frozen=True)
class Training2DCfg:
    data: DataLoader2DCfg = field(default_factory=DataLoader2DCfg)
    val_check_interval: int = 500
    max_steps: int = 2000


@dataclass(frozen=True)
class Checkpoint2DCfg:
    every_n_train_steps: int = 500
    load: Optional[str] = None
    out: Optional[Path] = None  # the params .npz (the tutorials read it)


@dataclass(frozen=True)
class Pipeline2DCfg:
    dataset: Dataset2DGroupCfg = field(default_factory=Dataset2DGroupCfg)
    wrapper: Wrapper2DCfg = field(default_factory=Wrapper2DCfg)
    wandb: WandbCfg = field(default_factory=WandbCfg)
    training: Training2DCfg = field(default_factory=Training2DCfg)
    checkpoint: Checkpoint2DCfg = field(default_factory=Checkpoint2DCfg)
    seed: int = 0
    # write synthetic trajectories under dataset.root when it has none
    make_synthetic: bool = False


def get_typed_2d_config(cfg_dict) -> Pipeline2DCfg:
    from ..config.tools import from_dict

    return from_dict(Pipeline2DCfg, cfg_dict)
