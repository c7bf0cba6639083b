from .sampler import (BPRSampler, DeviceBPRSampler, available_samplers,
                      make_sampler)
from .synthetic import (DATASET_PRESETS, DriftStream, StreamStep,
                        drifting_coclusters, paperlike_dataset,
                        planted_coclusters)

__all__ = ["DATASET_PRESETS", "paperlike_dataset", "planted_coclusters",
           "drifting_coclusters", "DriftStream", "StreamStep",
           "BPRSampler", "DeviceBPRSampler", "available_samplers",
           "make_sampler"]
