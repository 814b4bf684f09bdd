"""The benchmark's plain PyTorch reference of MCVD's NCSN++, DDPM sampling
and training step (float32), against which `correct` is decided. It imports
torch and numpy only, nothing of the program under test."""

from .diffusion import Adam, ddpm_block, dsm_loss, predict, sampler_tables, schedule
from .ncsnpp import NCSNpp, Plan, num_groups
from .precision import PRECISIONS, Precision

__all__ = ["Adam", "NCSNpp", "PRECISIONS", "Plan", "Precision", "ddpm_block", "dsm_loss",
           "num_groups", "predict", "sampler_tables", "schedule"]
