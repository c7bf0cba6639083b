"""Training side of the port: the LightGCN + BPR trainer with its host
and fused backends, the optimizers, checkpoints and bundle I/O, and
streaming Recall/NDCG@K evaluation (port of ``repro.training``; the
reference's compression and CCE modules are not ported)."""
from . import checkpoint, eval, optimizer
from .eval import recall_ndcg_at_k, topk_from_scores, topk_streaming
from .train_loop import (TrainConfig, Trainer, TrainerBackend,
                         available_trainer_backends,
                         normalize_trainer_backend, register_trainer_backend)

__all__ = ["checkpoint", "eval", "optimizer", "TrainConfig", "Trainer",
           "TrainerBackend", "available_trainer_backends",
           "normalize_trainer_backend", "register_trainer_backend",
           "recall_ndcg_at_k", "topk_from_scores", "topk_streaming"]
