"""Exact full-corpus evaluation of the PyTorch port."""

from twotower_tpu_torch.evaluation.evaluator import Evaluator
from twotower_tpu_torch.evaluation.metrics import merge_metric_sums, metrics_at_k, rank_of_true_item

__all__ = ["Evaluator", "merge_metric_sums", "metrics_at_k", "rank_of_true_item"]
