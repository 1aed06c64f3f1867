from .common import (
    CONFIG_DIR,
    CheckpointCfg,
    DataLoaderCfg,
    OptimCfg,
    PipelineCfg,
    TrainingCfg,
    ValidationCfg,
    WandbCfg,
    get_typed_root_config,
)
from .tools import deep_merge, from_dict, load_config
