from .transforms import data_transform, inverse_data_transform

__all__ = ["data_transform", "inverse_data_transform"]
