"""The host data pipeline (PyTorch counterpart of the JAX package's data/):
nerfstudio-format scenes parsed and decoded on the host in NumPy, items
collated into the port's RawBatch of CPU tensors."""

from .augmentation import (
    RandomBackground,
    ZeroMaskPatchedImage,
    get_random_image,
    random_horizontal_flip,
    random_vertical_flip,
)
from .conventions import (
    denormalize_intrinsics,
    get_optical_flow_filename,
    get_traj_and_frame_idx,
    get_trgt_view_filename,
    normalize,
    normalize_intrinsics,
    post_process_camera_to_world,
)
from .dataparser import (
    DataparserConfig,
    DataparserOutputs,
    auto_orient_and_center_poses,
    merge_dataparser_outputs,
    parse_transforms,
)
from .dataset import (
    DATASETS,
    DatasetAllegro,
    DatasetCfgCommon,
    DatasetCommon,
    DatasetHsa,
    DatasetPneumaticHandOnly,
    DatasetToyArm,
    get_dataset,
)
from .loader import DataLoader, ValidationWrapper, collate
from .synthetic import make_synthetic_scene
