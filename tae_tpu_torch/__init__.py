"""tae_tpu_torch — the PyTorch + CUDA (Hopper) port of ``tae_tpu``.

The package mirrors ``tae_tpu``'s module layout so every port module sits at
the same relative path as its JAX counterpart:

- ``nn/vit.py``, ``models/tae.py``, ``tokenizer.py``: the tokenizer as
  ``nn.Module``s, served in bf16 and int8 and trained in bf16;
- ``ops/``: plain PyTorch versions of every op, plus ``ops/cuda/``, the
  wrappers of the hand-written sm_90a kernels in ``csrc/`` (the counterparts
  of ``tae_tpu/ops/pallas/``);
- ``train/``: AdamW, the schedules and the train / eval step factories;
- ``ckpt/``: ``bridge.py`` (JAX parameter, gradient and optimizer-state trees,
  calibration statistics and reference ``.pth`` files into the port's
  layout), ``io.py`` (checkpoints), ``interpolate.py`` (positional-embedding
  resize);
- ``calibrate.py``: the activation statistics of the quantized modes;
- ``cli/``: the encode, evaluate and train drivers, on the host data code
  of ``data/`` (transforms, tar shards, ImageFolder, worker loader and
  device prefetch, the native JPEG decoder) and ``utils/`` (meters, image
  grids).

A wrapper in ``ops/cuda`` runs its plain version only for a tensor on the
CPU; for a CUDA tensor it launches its kernel or raises. The kernels are
built with ``nvcc`` at first use (see ``ops/cuda/build.py``).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from tae_tpu_torch.utils.dtypes import Policy  # noqa: F401
