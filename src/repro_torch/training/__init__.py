"""Training side of the port: the LightGCN + BPR trainer with its host,
fused and data-parallel fused_sharded backends, the optimizers,
checkpoints and bundle I/O, streaming Recall/NDCG@K evaluation, the
all-reduce gradient compression and the CCE baseline (port of
``repro.training``)."""
from . import cce, checkpoint, compress, eval, optimizer
from .eval import recall_ndcg_at_k, topk_from_scores, topk_streaming
from .train_loop import (TrainConfig, Trainer, TrainerBackend,
                         available_trainer_backends,
                         normalize_trainer_backend, register_trainer_backend)

__all__ = ["cce", "checkpoint", "compress", "eval", "optimizer", "TrainConfig", "Trainer",
           "TrainerBackend", "available_trainer_backends",
           "normalize_trainer_backend", "register_trainer_backend",
           "recall_ndcg_at_k", "topk_from_scores", "topk_streaming"]
