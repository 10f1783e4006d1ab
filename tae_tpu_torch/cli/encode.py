"""Dataset tokenization driver (counterpart of ``tae_tpu/cli/encode.py``).

Runs the frozen TAE encoder over a webdataset stream and writes fp16
``{latents, targets}`` in numbered ``{prefix}_latents-NNNNNN.npz`` shards of
``--shard_size`` samples plus a ``{prefix}_index.json``, the JAX driver's
layout (``--pth_output`` also writes the reference's monolithic ``.pth``).
The model is ``Tokenizer.from_checkpoint(component="encoder", ...)``: bf16,
or int8 / int4 with ``--quantization``. Decoding runs in worker processes,
batches reach the card through pinned ``non_blocking`` copies on a side
stream (``data/loader.device_prefetch``), and the latents of batch k come
back by a pinned ``non_blocking`` copy that overlaps the encode of batch
k+1.

Like the reference, the default transform is the train-style random crop
(encode.py:55-60); ``--deterministic`` takes the val-style centre crop.

Run: ``python -m tae_tpu_torch.cli.encode --model tae_patch16_vocab256_px256
--model_ckpt ckpt.pth --data_path 'shards-{000000..000099}.tar'
--output_dir out --save_prefix train`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import collections
import functools
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from tae_tpu_torch.cli import _common
from tae_tpu_torch.data.loader import BatchLoader, device_prefetch
from tae_tpu_torch.data.tar_stream import (ShardSpec, WebDatasetReader,
                                           decode_jpg_cls)
from tae_tpu_torch.data.transforms import (center_crop_transform,
                                           random_resized_crop_transform)


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Encode a dataset with a TAE", add_help=False)
    p.add_argument("--batch_size", default=1024, type=int)
    p.add_argument("--num_iters", default=10000, type=int,
                   help="max number of batches to encode")
    p.add_argument("--model", default="", type=str)
    p.add_argument("--model_ckpt", default="", type=str)
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--output_dir", default="", type=str)
    p.add_argument("--save_prefix", default="", type=str)
    p.add_argument("--shard_size", default=65536, type=int,
                   help="samples per output shard")
    p.add_argument("--pth_output", default="", type=str,
                   help="additionally write the reference's monolithic "
                        "{latents, targets} .pth (encode.py:93-100 format; "
                        "loads the full dump into host RAM)")
    p.add_argument("--deterministic", action="store_true",
                   help="use the val transform instead of the reference's "
                        "train-style random crop")
    p.add_argument("--device_normalize", action="store_true",
                   help="ship uint8 pixels and normalize on device (4x "
                        "smaller H2D copies; needs the native decoder)")
    p.add_argument("--patch_layout", action="store_true",
                   help="native decoder writes pre-patchified (N, C*p*p) "
                        "batches so patch embedding is a pure matmul with "
                        "zero on-device relayout")
    p.add_argument("--equalize", type=float, default=0.0,
                   help="SmoothQuant-style activation-outlier equalization "
                        "alpha (0 = off; 0.5 typical) applied to the float "
                        "params before --quantization: an exact LN-affine "
                        "fold, no run-time cost (tae_tpu_torch.ops.int8."
                        "equalize_params_; measured stats go through the "
                        "library API, Tokenizer.from_checkpoint(act_amax= "
                        "or calib_images=))")
    p.add_argument("--quantization", default=None, choices=["int8", "int4"],
                   help="opt-in quantized serving path: int8 = w8a8 fused "
                        "block kernels; int4 = w4a8 packed block weights "
                        "(half the weight bytes, for the weight-bound "
                        "small-batch regime; a coarser code, see "
                        "tae_tpu_torch/ops/int4.py)")
    _common.add_device_args(p)
    return p


def _encode_iter(path: str, input_size: int, deterministic: bool, seed: int,
                 worker_id: int, num_workers: int):
    """PIL fallback path (native library unavailable)."""
    spec = ShardSpec.from_string(path, resampled=False)
    reader = WebDatasetReader(spec, decode=decode_jpg_cls,
                              shard_index=worker_id, shard_count=num_workers)
    if deterministic:
        tf = center_crop_transform(input_size, pad=32)
        for img, cls in reader:
            yield tf(img), np.int32(cls)
    else:
        tf = random_resized_crop_transform(input_size)
        rng = np.random.default_rng(seed + worker_id)
        for img, cls in reader:
            yield tf(img, rng), np.int32(cls)


def _encode_iter_batched(path: str, input_size: int, deterministic: bool,
                         seed: int, batch_size: int, u8: bool,
                         patch_size: int,
                         worker_id: int, num_workers: int):
    """Native batched path: raw tar bytes -> fused C++ decode_batch straight
    into the batch buffer (no per-sample arrays, no np.stack collate — the
    collate copy alone costs ~40% of host time on the per-sample path).
    ``u8=True`` emits raw uint8 pixels for on-device normalization."""
    from tae_tpu_torch.data import native
    from tae_tpu_torch.data.transforms import _sample_rrc_box

    spec = ShardSpec.from_string(path, resampled=False)
    reader = WebDatasetReader(spec, decode=None,
                              shard_index=worker_id, shard_count=num_workers)
    rng = np.random.default_rng(seed + worker_id)
    threads = _common.decode_threads(num_workers)

    def flush(datas: list[bytes], clss: list[int]):
        boxes = np.empty((len(datas), 4), np.float32)
        flips = np.zeros((len(datas),), np.int32)
        keep_d, keep_c = [], []
        for data, cls in zip(datas, clss):
            try:
                w, h = native.jpeg_size(data)
            except ValueError:
                continue
            i = len(keep_d)
            if deterministic:
                side = min(w, h) * input_size / float(input_size + 32)
                cx, cy = w / 2.0, h / 2.0
                boxes[i] = (cx - side / 2, cy - side / 2,
                            cx + side / 2, cy + side / 2)
            else:
                top, left, bh, bw = _sample_rrc_box(rng, w, h, (0.2, 1.0),
                                                    (3 / 4, 4 / 3))
                boxes[i] = (left, top, left + bw, top + bh)
                flips[i] = rng.random() < 0.5
            keep_d.append(data)
            keep_c.append(cls)
        if not keep_d:
            return None
        decode = native.decode_batch_u8 if u8 else native.decode_batch
        imgs, keep = decode(keep_d, boxes[:len(keep_d)], flips[:len(keep_d)],
                            input_size, threads=threads,
                            patch_size=patch_size, skip_failed=True)
        cls_arr = np.asarray(keep_c, np.int32)
        if keep is not None:  # drop the (rare) undecodable images' labels too
            cls_arr = cls_arr[keep]
        if not len(imgs):
            return None
        return imgs, cls_arr

    datas: list[bytes] = []
    clss: list[int] = []
    for sample in reader:
        if "jpg" not in sample:
            continue
        cls = sample.get("cls", b"-1")
        datas.append(bytes(sample["jpg"]))
        clss.append(int(cls.decode()) if isinstance(cls, bytes) else int(cls))
        if len(datas) == batch_size:
            out = flush(datas, clss)
            if out is not None:
                yield out
            datas, clss = [], []
    if datas:
        out = flush(datas, clss)
        if out is not None:
            yield out


def make_encode_loader(data_path: str, input_size: int, deterministic: bool,
                       seed: int, batch_size: int, num_workers: int,
                       u8: bool = False, patch_size: int = 0) -> BatchLoader:
    """Loader for the tokenization input path: native batched decode when
    libtaedata is available, per-sample PIL otherwise. ``patch_size > 0``
    emits pre-patchified (N, C·p²) batches (extract_patches layout)."""
    from tae_tpu_torch.data import native

    if native.available():
        make_iter = functools.partial(_encode_iter_batched, data_path,
                                      input_size, deterministic, seed,
                                      batch_size, u8, patch_size)
        return BatchLoader(make_iter, batch_size, num_workers=num_workers,
                           prebatched=True)
    if u8 or patch_size:
        # the flags are pure input-layout accelerators (uint8 H2D /
        # pre-patchified); the PIL path yields normalized float CHW which
        # the same encode step consumes unchanged — degrade, don't die
        print("WARNING: --device_normalize/--patch_layout need the native "
              "decoder (native/taedata.cpp, built at first use with g++ and "
              "libjpeg); taking the PIL path", flush=True)
    make_iter = functools.partial(_encode_iter, data_path, input_size,
                                  deterministic, seed)
    return BatchLoader(make_iter, batch_size, num_workers=num_workers)


class ShardWriter:
    """Accumulate (latents, targets) and flush ``.npz`` shards + an index."""

    def __init__(self, output_dir: Path, prefix: str, shard_size: int):
        self.dir = output_dir
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.shard_size = shard_size
        self.buf_z: list[np.ndarray] = []
        self.buf_t: list[np.ndarray] = []
        self.buffered = 0
        self.shards: list[dict] = []

    def add(self, latents: np.ndarray, targets: np.ndarray) -> None:
        self.buf_z.append(latents)
        self.buf_t.append(targets)
        self.buffered += latents.shape[0]
        while self.buffered >= self.shard_size:
            self._flush(self.shard_size)

    def _flush(self, count: int) -> None:
        z = np.concatenate(self.buf_z, axis=0)
        t = np.concatenate(self.buf_t, axis=0)
        out_z, rest_z = z[:count], z[count:]
        out_t, rest_t = t[:count], t[count:]
        idx = len(self.shards)
        path = self.dir / f"{self.prefix}_latents-{idx:06d}.npz"
        np.savez(path, latents=out_z, targets=out_t)
        self.shards.append({"path": path.name, "num_samples": int(out_z.shape[0])})
        self.buf_z, self.buf_t = [rest_z], [rest_t]
        self.buffered = int(rest_z.shape[0])
        print(f"wrote {path} ({out_z.shape[0]} samples)")

    def close(self) -> None:
        if self.buffered:
            self._flush(self.buffered)
        index = {"shards": self.shards,
                 "num_samples": int(sum(s["num_samples"] for s in self.shards))}
        (self.dir / f"{self.prefix}_index.json").write_text(json.dumps(index, indent=2))


def main(args) -> dict:
    from tae_tpu_torch.tokenizer import Tokenizer

    print(f"{args}".replace(", ", ",\n"))
    device = _common.device_of(args)
    if args.equalize and args.quantization not in ("int8", "int4"):
        raise SystemExit("--equalize requires --quantization int8/int4")
    # an inference-only driver: parameters in the compute dtype (bf16), and
    # the decoder dropped before quantization, which never runs on it
    tok = Tokenizer.from_checkpoint(
        args.model, ckpt=args.model_ckpt or None, dtype=torch.bfloat16,
        device=device, quantization=args.quantization, component="encoder",
        equalize=args.equalize or None, patch_input=bool(args.patch_layout),
        seed=args.seed,
        **(json.loads(args.model_args) if args.model_args else {}))
    tok.backend = args.attn_backend
    if args.model_ckpt:
        print(f"Loaded checkpoint {args.model_ckpt}")
    cfg = tok.model.cfg

    _common.print_decoder()
    loader = make_encode_loader(args.data_path, args.input_size,
                                args.deterministic, args.seed,
                                args.batch_size, args.num_workers,
                                u8=args.device_normalize,
                                patch_size=(cfg.patch_size
                                            if args.patch_layout else 0))
    writer = ShardWriter(Path(args.output_dir), args.save_prefix, args.shard_size)
    t0 = time.time()
    n_imgs = 0

    # the copy of batch k+1 / k+2 to the card overlaps the encode of batch k
    # (metadata rides a host-side deque in lockstep)
    meta_q: collections.deque = collections.deque()

    def host_imgs():
        for imgs, targets in itertools.islice(loader, args.num_iters):
            padded, n = _common.pad_batch(imgs, args.batch_size)
            meta_q.append((np.asarray(targets), n))
            yield padded

    def fetch(z: torch.Tensor):
        """Start the copy of fp16 latents to pinned host memory; the event
        says when it has landed."""
        z16 = z.to(torch.float16)
        if z16.device.type != "cuda":
            return z16, None
        host = torch.empty(z16.shape, dtype=torch.float16, pin_memory=True)
        host.copy_(z16, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def land(pending) -> None:
        (host, done), targets, n = pending
        if done is not None:
            done.synchronize()
        writer.add(host.numpy()[:n], targets)

    pending = None  # the copy of batch k lands while batch k+1 encodes
    for it, dev_imgs in enumerate(device_prefetch(host_imgs(), device)):
        targets, n = meta_q.popleft()
        z = tok.encode(dev_imgs)
        if pending is not None:
            land(pending)
        pending = (fetch(z), targets, n)
        n_imgs += n
        if it % 100 == 0:
            print(f"Iteration {it}: {n_imgs / max(time.time() - t0, 1e-9):.0f} img/s")
    if pending is not None:
        land(pending)
    writer.close()
    if args.pth_output:
        from tae_tpu_torch.data.latents import shards_to_pth

        n_pth = shards_to_pth(
            Path(args.output_dir) / f"{args.save_prefix}_index.json",
            args.pth_output)
        print(f"wrote {args.pth_output} ({n_pth} samples, reference format)")
    dt = time.time() - t0
    stats = {"num_samples": n_imgs, "seconds": dt,
             "images_per_sec": n_imgs / max(dt, 1e-9)}
    print(f"Encoded {n_imgs} samples in {dt:.1f}s "
          f"({stats['images_per_sec']:.0f} img/s)")
    return stats


def cli_main() -> None:
    args = get_args_parser().parse_args()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli_main()
