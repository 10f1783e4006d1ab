"""Classification losses and accuracy metrics (counterpart of
``tae_tpu/train/losses.py``).

The reference's ``CrossEntropyLoss`` with integer or probability targets and
optional label smoothing (reference recognition/train_recognition_in1k.py:122:
smoothing 0.1; in19k plain CE), and top-k accuracy in percent (reference
util/misc.py:383-397). Both return 0-dim tensors on the logits' device: a
train step reads nothing back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """logits (B, C); targets integer (B,) or soft distributions (B, C).

    torch semantics: smoothing mixes the target with uniform 1/C; the loss
    is the mean over the batch, computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    c = logits.shape[-1]
    if targets.ndim == logits.ndim:
        t = targets.float()
    else:
        t = F.one_hot(targets.long(), c).float()
    if label_smoothing:
        t = t * (1.0 - label_smoothing) + label_smoothing / c
    return -(t * logp).sum(dim=-1).mean()


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  ks: tuple[int, ...] = (1, 5)) -> dict[str, torch.Tensor]:
    """Percent accuracy over the batch for each k. Soft targets are scored
    against their dominant class (as torchvision reports mixup batches); k
    is clamped to the class count, so tiny label spaces work."""
    if targets.ndim == logits.ndim:
        targets = targets.argmax(dim=-1)
    c = logits.shape[-1]
    maxk = min(max(ks), c)
    pred = logits.float().topk(maxk, dim=-1).indices            # (B, maxk)
    correct = pred == targets.long()[:, None]
    return {f"acc{k}": 100.0 * correct[:, :min(k, c)].any(dim=-1).float().mean()
            for k in ks}
