"""Training of the port, stage 1 (perception) and stage 2 (action): batch
preparation, losses, the Adam train state and step, and checkpoints
(PyTorch counterparts of the JAX package's training/)."""

from .checkpoint import CheckpointManager, load_batch_stats, load_params_only
from .losses import LossCfg, action_loss, perception_loss
from .prepare import RawBatch, denormalize_intrinsics, prepare_training_batch
from .train import (
    TrainCfg,
    TrainState,
    apply_gradients,
    create_train_state,
    host_step_schedule,
    make_optimizer,
    merge_compatible_params,
    train_step,
    trainable_mask,
)
