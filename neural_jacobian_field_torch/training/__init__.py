"""Training of the port, stage 1 (perception) and stage 2 (action): batch
preparation, losses, the Adam train state, the train step and its
captured programs (one step per gate, K steps per call), and checkpoints
(PyTorch counterparts of the JAX package's training/)."""

from .checkpoint import CheckpointManager, load_batch_stats, load_params_only
from .losses import LossCfg, action_loss, perception_loss
from .optim import Adam
from .prepare import RawBatch, denormalize_intrinsics, prepare_training_batch
from .train import (
    MultiStepDispatch,
    TrainCfg,
    TrainState,
    apply_gradients,
    create_train_state,
    host_step_schedule,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    merge_compatible_params,
    stack_batches,
    step_randomness,
    train_step,
    trainable_mask,
)
