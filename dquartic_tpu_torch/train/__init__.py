"""Training: optimizer, schedule, checkpoints and the Trainer."""

from .callbacks import CallbackHandler
from .checkpoint import LATEST_NAME, latest_path_for, load_checkpoint, save_checkpoint
from .optim import ClippedAdamW, WarmupCosineSchedule, make_optimizer
from .trainer import Trainer
