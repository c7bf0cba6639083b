from .synthetic import DATASET_PRESETS, paperlike_dataset, planted_coclusters

__all__ = ["DATASET_PRESETS", "paperlike_dataset", "planted_coclusters"]
