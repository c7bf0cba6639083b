"""Training side of the port: the LightGCN + BPR trainer with its host
and fused backends, the optimizers, checkpoints and bundle I/O, and
streaming Recall/NDCG@K evaluation, and the CCE baseline (port of
``repro.training``; the reference's all-reduce compression is not
ported)."""
from . import cce, checkpoint, eval, optimizer
from .eval import recall_ndcg_at_k, topk_from_scores, topk_streaming
from .train_loop import (TrainConfig, Trainer, TrainerBackend,
                         available_trainer_backends,
                         normalize_trainer_backend, register_trainer_backend)

__all__ = ["cce", "checkpoint", "eval", "optimizer", "TrainConfig", "Trainer",
           "TrainerBackend", "available_trainer_backends",
           "normalize_trainer_backend", "register_trainer_backend",
           "recall_ndcg_at_k", "topk_from_scores", "topk_streaming"]
