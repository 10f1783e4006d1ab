"""Bicubic positional-embedding interpolation for resolution transfer
(counterpart of ``tae_tpu/ckpt/interpolate.py``).

torch's ``interpolate(mode="bicubic", align_corners=False)`` as two
separable resize matrices: cubic convolution with A = −0.75, half-pixel
centred source coordinates, edge clamping. The matrices are built with
numpy in float64, as the JAX package builds them, so both give the same
embeddings for a transferred checkpoint.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic-convolution weights for the 4 taps around fractional offset t."""
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    s = 1 - t
    w2 = ((a + 2) * s - (a + 3)) * s * s + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)  # (new, 4)


def _resize_matrix(old: int, new: int) -> np.ndarray:
    """(new, old) matrix of a 1-D bicubic resize (align_corners=False:
    src = (i + 0.5)·old/new − 0.5; edges clamped)."""
    i = np.arange(new, dtype=np.float64)
    src = (i + 0.5) * (old / new) - 0.5
    x0 = np.floor(src)
    weights = _cubic_weights(src - x0)                 # (new, 4)
    mat = np.zeros((new, old), dtype=np.float64)
    for tap in range(4):
        idx = np.clip(x0.astype(np.int64) - 1 + tap, 0, old - 1)
        np.add.at(mat, (np.arange(new), idx), weights[:, tap])
    return mat.astype(np.float32)


def interpolate_pos_embed(pos: torch.Tensor, new_num_patches: int
                          ) -> torch.Tensor:
    """pos: (1, N_old, E) -> (1, new_num_patches, E)."""
    _, n_old, e = pos.shape
    if n_old == new_num_patches:
        return pos
    old, new = math.isqrt(n_old), math.isqrt(new_num_patches)
    if old * old != n_old or new * new != new_num_patches:
        raise ValueError(f"pos-embed grids must be square: {n_old} -> "
                         f"{new_num_patches}")
    grid = pos.reshape(old, old, e).float()
    m = torch.from_numpy(_resize_matrix(old, new)).to(grid.device)
    # rows, then columns
    grid = torch.einsum("ij,jke->ike", m, grid)
    grid = torch.einsum("kj,ije->ike", m, grid)
    return grid.reshape(1, new * new, e).to(pos.dtype)


def maybe_interpolate_tree(loaded: Mapping[str, torch.Tensor],
                           target: Mapping[str, torch.Tensor]
                           ) -> dict[str, torch.Tensor]:
    """A loaded state_dict with every ``*pos_embed`` entry whose token count
    differs from the model's (``target``: its state_dict) resized to it."""
    out = {}
    for k, v in loaded.items():
        t = target.get(k)
        if k.endswith("pos_embed") and t is not None and v.shape != t.shape:
            v = interpolate_pos_embed(v, t.shape[-2])
        out[k] = v
    return out
