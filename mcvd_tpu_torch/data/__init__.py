from .conditioning import conditioning_fn, fold_frames, get_mode, unfold_frames
from .transforms import data_transform, inverse_data_transform

__all__ = ["conditioning_fn", "data_transform", "fold_frames", "get_mode",
           "inverse_data_transform", "unfold_frames"]
