"""Reader for encoded latent shards, the encode driver's output
(counterpart of ``tae_tpu/data/latents.py``, numpy only and copied as it is).

``tae_tpu_torch.cli.encode`` writes ``{prefix}_latents-NNNNNN.npz`` shards
plus a ``{prefix}_index.json``, the JAX driver's layout. This reader streams
(latents, target) samples back, and also accepts the reference's monolithic
``{"latents", "targets"}`` ``.pth`` dump; :func:`shards_to_pth` writes one.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np


def shards_to_pth(index_path: str | Path, out_path: str | Path) -> int:
    """Concatenate encode-CLI ``.npz`` shards into the reference's monolithic
    ``{latents, targets}`` ``.pth`` (reference encode.py:93-100 format), for
    handing latent dumps back to PyTorch consumers. Loads everything into
    host RAM — that is the reference format's own design (its encode job
    requests 750 GB, reference scripts/encode.sh:7). Returns sample count."""
    import torch

    ds = LatentDataset(index_path)
    if ds._arrays is not None:
        raise ValueError("input is already a .pth dump")
    zs, ts = [], []
    for shard in ds.shards:
        with np.load(ds.dir / shard["path"]) as data:
            zs.append(data["latents"])
            ts.append(data["targets"])
    z = torch.from_numpy(np.ascontiguousarray(np.concatenate(zs, axis=0)))
    t = torch.from_numpy(np.concatenate(ts, axis=0)).to(torch.int64)
    torch.save({"latents": z, "targets": t}, out_path)
    return int(t.shape[0])


class LatentDataset:
    def __init__(self, index_path: str | Path):
        index_path = Path(index_path)
        if index_path.is_dir():
            matches = sorted(index_path.glob("*_index.json"))
            if not matches:
                raise FileNotFoundError(f"no *_index.json under {index_path}")
            index_path = matches[0]
        self.dir = index_path.parent
        self._arrays = None
        if index_path.suffix in (".pth", ".pt"):
            # reference encode.py:99-100 monolithic dump
            import torch

            blob = torch.load(index_path, map_location="cpu",
                              weights_only=True)
            z = blob["latents"].to(torch.float32).numpy()
            t = blob["targets"].numpy().reshape(-1)
            if len(z) != len(t):
                raise ValueError(
                    f"{index_path}: latents ({len(z)}) / targets ({len(t)}) "
                    f"length mismatch")
            self._arrays = (z, t)
            self.shards = [{"path": str(index_path), "num_samples": len(z)}]
            self.num_samples = len(z)
            return
        index = json.loads(index_path.read_text())
        self.shards = index["shards"]
        self.num_samples = index["num_samples"]

    def __len__(self) -> int:
        return self.num_samples

    def iter_samples(self, shard_index: int = 0, shard_count: int = 1,
                     loop: bool = False, seed: int = 0
                     ) -> Iterator[tuple[np.ndarray, np.int64]]:
        """Stream samples from this worker's shard subset; ``loop=True``
        reshuffles shard order each pass (training mode)."""
        rng = np.random.default_rng(seed)
        if self._arrays is not None:
            # monolithic .pth: workers stride over samples instead of shards
            z, t = self._arrays
            mine = np.arange(shard_index, len(z), shard_count)
            if mine.size == 0:
                mine = np.arange(len(z))
            while True:
                order = rng.permutation(mine) if loop else mine
                for i in order:
                    yield z[int(i)].astype(np.float32), np.int64(t[int(i)])
                if not loop:
                    return
        my_shards = self.shards[shard_index::shard_count] or self.shards
        while True:
            order = rng.permutation(len(my_shards)) if loop else range(len(my_shards))
            for si in order:
                with np.load(self.dir / my_shards[int(si)]["path"]) as data:
                    z = data["latents"]
                    t = data["targets"]
                idx = rng.permutation(len(z)) if loop else range(len(z))
                for i in idx:
                    yield z[int(i)].astype(np.float32), np.int64(t[int(i)])
            if not loop:
                return
