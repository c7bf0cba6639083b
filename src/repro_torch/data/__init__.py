from .neighbor_sampler import random_regular_csr, sample_subgraph
from .sampler import (BPRSampler, DeviceBPRSampler, available_samplers,
                      make_sampler)
from .synthetic import (DATASET_PRESETS, DriftStream, StreamStep,
                        drifting_coclusters, paperlike_dataset,
                        planted_coclusters, synthetic_bipartite)

__all__ = ["DATASET_PRESETS", "paperlike_dataset", "planted_coclusters",
           "synthetic_bipartite",
           "drifting_coclusters", "DriftStream", "StreamStep",
           "BPRSampler", "DeviceBPRSampler", "available_samplers",
           "make_sampler", "random_regular_csr", "sample_subgraph"]
