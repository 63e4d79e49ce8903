"""Training: optimizer, schedule, checkpoints and the Trainer."""

from .callbacks import CallbackHandler
from .checkpoint import (
    LATEST_NAME, checkpoint_params, latest_path_for, load_checkpoint, save_checkpoint,
)
from .optim import ClippedAdamW, ClippedFactoredRMS, WarmupCosineSchedule, make_optimizer
from .trainer import Trainer
