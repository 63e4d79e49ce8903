from .diffusion import DDIMProcess, sample_timesteps
from .schedules import DiffusionSchedule, make_schedule

__all__ = ["DDIMProcess", "DiffusionSchedule", "make_schedule", "sample_timesteps"]
