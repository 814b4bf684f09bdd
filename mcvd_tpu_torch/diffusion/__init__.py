from . import samplers
from .loss import dsm_loss
from .schedules import DiffusionSchedule, get_sigmas, make_schedule, subsample_schedule

__all__ = ["DiffusionSchedule", "dsm_loss", "get_sigmas", "make_schedule",
           "subsample_schedule", "samplers"]
