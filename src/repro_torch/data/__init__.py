from .sampler import (BPRSampler, DeviceBPRSampler, available_samplers,
                      make_sampler)
from .synthetic import DATASET_PRESETS, paperlike_dataset, planted_coclusters

__all__ = ["DATASET_PRESETS", "paperlike_dataset", "planted_coclusters",
           "BPRSampler", "DeviceBPRSampler", "available_samplers",
           "make_sampler"]
