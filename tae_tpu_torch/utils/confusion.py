"""Confusion matrix for segmentation evaluation (counterpart of
``tae_tpu/utils/confusion.py``).

The reference's ConfusionMatrix (reference segmentation/utils.py:66-100): a
bincount over the valid pixels (0 <= target < num_classes), global and
per-class accuracy, per-class IoU and mean IoU, and the same printable
summary. The update is a ``torch.bincount`` on the predictions' device; the
matrix accumulates as int64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _counts(target: torch.Tensor, pred: torch.Tensor, n: int) -> torch.Tensor:
    p = pred.reshape(-1).long()
    t = target.reshape(-1).long().to(p.device)
    valid = (t >= 0) & (t < n)
    idx = torch.where(valid, n * t + p, torch.full_like(t, n * n))
    return torch.bincount(idx, minlength=n * n + 1)[: n * n].reshape(n, n)


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, target, pred) -> None:
        """``target`` and ``pred``: integer arrays or tensors of one shape;
        pixels whose target lies outside [0, num_classes) (255: ignore) are
        not counted."""
        counts = _counts(torch.as_tensor(target), torch.as_tensor(pred),
                         self.num_classes)
        self.mat += counts.cpu().numpy().astype(np.int64)

    def reset(self) -> None:
        self.mat[:] = 0

    def compute(self) -> tuple[float, np.ndarray, np.ndarray]:
        h = self.mat.astype(np.float64)
        diag = np.diag(h)
        acc_global = diag.sum() / max(h.sum(), 1)
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = diag / h.sum(1)
            iou = diag / (h.sum(1) + h.sum(0) - diag)
        return float(acc_global), acc, iou

    def reduce_from_all_processes(self, mesh=None) -> None:
        """Sum the matrices of every process, the tensor peers of ``mesh``
        counted once
        (``parallel.mesh.all_reduce_sum``; nothing to do in a world of 1).
        The counts travel as float64, exact below 2**53 pixels."""
        from tae_tpu_torch.parallel.mesh import all_reduce_sum, world_size

        if world_size() == 1:
            return
        self.mat = np.rint(all_reduce_sum(self.mat, mesh)).astype(np.int64)

    @property
    def mean_iou(self) -> float:
        _, _, iou = self.compute()
        return float(np.nanmean(iou))

    def __str__(self) -> str:
        acc_global, acc, iou = self.compute()
        return ("global correct: {:.1f}\naverage row correct: {}\n"
                "IoU: {}\nmean IoU: {:.1f}").format(
            acc_global * 100,
            [f"{i:.1f}" for i in (acc * 100).tolist()],
            [f"{i:.1f}" for i in (iou * 100).tolist()],
            float(np.nanmean(iou)) * 100)
