from . import samplers
from .schedules import DiffusionSchedule, get_sigmas, make_schedule, subsample_schedule

__all__ = ["DiffusionSchedule", "get_sigmas", "make_schedule", "subsample_schedule",
           "samplers"]
