"""Streaming webdataset-style tar reader (counterpart of
``tae_tpu/data/tar_stream.py``, copied as it is: the same shard split across
processes and workers, the same shuffle order from the same seed).

  * brace-expansion shard specs (``shards-{000000..000123}.tar``) and globs;
  * sequential tar streaming, members read in file order;
  * samples grouped by key (basename up to the first dot), one dict of
    ``{extension: raw bytes}`` per sample;
  * ``resampled=True``: an infinite stream, each worker sampling shards with
    replacement (training); ``resampled=False``: one deterministic pass
    (encoding);
  * a reservoir shuffle buffer;
  * shard-level splitting across (process, worker).
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import io
import random
import re
import tarfile
from pathlib import Path
from typing import Any, Callable, Iterator

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shards(spec: str | list[str]) -> list[str]:
    """Expand ``{000..123}`` ranges and filesystem globs into a shard list."""
    if isinstance(spec, (list, tuple)):
        out: list[str] = []
        for s in spec:
            out.extend(expand_shards(s))
        return out
    m = _BRACE.search(spec)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [
            spec[:m.start()] + str(i).zfill(width) + spec[m.end():]
            for i in range(int(lo), int(hi) + 1)
        ]
    if spec.startswith(("pipe:", "http://", "https://")):
        return [spec]  # brace ranges expand above; never filesystem-glob URLs
    if any(c in spec for c in "*?["):
        return sorted(globlib.glob(spec))
    return [spec]


def open_shard(url: str | Path):
    """Open one shard as a sequential byte stream (webdataset ``gopen``
    semantics, reference train.py:84 accepts the same URL forms):

      * ``pipe:CMD`` — run CMD through the shell, stream its stdout (the
        object-store pattern: ``pipe:gsutil cat gs://bucket/shard.tar``);
      * ``http(s)://`` — stream over HTTP;
      * ``file://`` or a plain path — local file.

    Returns (fileobj, closer) — call ``closer(completed)`` when done. For
    ``pipe:`` shards, ``completed=True`` (stream read to EOF) raises if the
    command exited non-zero — a silently truncated shard must not look like
    a short dataset; ``completed=False`` (consumer stopped early, e.g.
    ``--num_iters`` cut the stream) kills the producer and raises nothing,
    since the SIGPIPE/-13 exit it causes is expected, not an error.
    """
    url = str(url)
    if url.startswith("pipe:"):
        import subprocess

        proc = subprocess.Popen(url[len("pipe:"):], shell=True,
                                stdout=subprocess.PIPE)

        def close_pipe(completed: bool = True):
            if not completed:
                proc.kill()
            proc.stdout.close()
            rc = proc.wait()
            if completed and rc != 0:
                raise RuntimeError(f"shard pipe {url!r} exited with {rc}")

        return proc.stdout, close_pipe
    if url.startswith(("http://", "https://")):
        import urllib.request

        resp = urllib.request.urlopen(url)  # noqa: S310 - shard URL from config
        return resp, lambda completed=True: resp.close()
    if url.startswith("file://"):
        url = url[len("file://"):]
    f = open(url, "rb")
    return f, lambda completed=True: f.close()


def tar_samples(path: str | Path) -> Iterator[dict[str, Any]]:
    """Yield ``{"__key__": key, ext: bytes, ...}`` dicts from one tar shard
    (local path, ``pipe:`` command, or http(s) URL — see :func:`open_shard`).
    Members sharing a basename-up-to-first-dot form one sample (webdataset
    convention); a new key flushes the previous sample."""
    fileobj, closer = open_shard(path)
    completed = False
    try:
        yield from _tar_samples_from(fileobj)
        completed = True
    finally:
        closer(completed)


def _tar_samples_from(fileobj) -> Iterator[dict[str, Any]]:
    with tarfile.open(fileobj=fileobj, mode="r|*") as tf:  # streaming mode: sequential reads
        current_key: str | None = None
        sample: dict[str, Any] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = Path(member.name).name
            if name.startswith("."):
                continue
            if "." in name:
                key, ext = name.split(".", 1)
            else:
                key, ext = name, ""
            if key != current_key:
                if current_key is not None and sample:
                    yield sample
                current_key = key
                sample = {"__key__": key}
            f = tf.extractfile(member)
            if f is not None:
                sample[ext] = f.read()
        if current_key is not None and sample:
            yield sample


@dataclasses.dataclass
class ShardSpec:
    urls: list[str]
    resampled: bool = True
    seed: int | None = None

    @classmethod
    def from_string(cls, spec: str, resampled: bool = True,
                    seed: int | None = None) -> "ShardSpec":
        urls = expand_shards(spec)
        if not urls:
            raise FileNotFoundError(f"no shards match {spec!r}")
        return cls(urls=urls, resampled=resampled, seed=seed)


class WebDatasetReader:
    """Iterate decoded samples from a shard collection.

    ``shard_index``/``shard_count`` split the shard list across data-loading
    workers and hosts (each worker streams a disjoint subset; with
    ``resampled=True`` each worker instead resamples from its subset
    forever). ``decode`` maps the raw ``{ext: bytes}`` sample to whatever the
    trainer consumes; exceptions in decode skip the sample.
    """

    def __init__(self, shards: ShardSpec, decode: Callable[[dict], Any] | None = None,
                 shuffle_buffer: int = 0, shard_index: int = 0,
                 shard_count: int = 1):
        self.shards = shards
        self.decode = decode
        self.shuffle_buffer = shuffle_buffer
        urls = shards.urls
        if shard_count > 1:
            urls = urls[shard_index::shard_count]
            # With fewer shards than workers some slices are empty. For a
            # resampled (infinite) stream an idle worker would starve the
            # loader, so fall back to sampling from all shards; for a
            # deterministic single pass (encode.py) the worker must yield
            # NOTHING — falling back to all shards would re-emit the whole
            # dataset once per empty slice (reference .with_epoch never
            # duplicates, encode.py:63-64).
            if not urls and shards.resampled:
                urls = shards.urls
        self.urls = urls
        self._rng = random.Random(shards.seed if shards.seed is not None
                                  else (0x7AE + shard_index))

    def _shard_iter(self) -> Iterator[str]:
        if self.shards.resampled:
            while True:
                yield self._rng.choice(self.urls)
        else:
            yield from self.urls

    def _raw_iter(self) -> Iterator[dict]:
        for url in self._shard_iter():
            yield from tar_samples(url)

    def __iter__(self) -> Iterator[Any]:
        it = self._raw_iter()
        if self.shuffle_buffer > 1:
            it = _buffered_shuffle(it, self.shuffle_buffer, self._rng)
        if self.decode is None:
            yield from it
            return
        for sample in it:
            try:
                yield self.decode(sample)
            except Exception:
                continue


def _buffered_shuffle(it: Iterator, size: int, rng: random.Random) -> Iterator:
    """Reservoir shuffle: fill a buffer, then emit a random element as each
    new one arrives (reference pipeline's .shuffle(10000, initial=10000))."""
    buf: list[Any] = []
    for x in it:
        if len(buf) < size:
            buf.append(x)
            continue
        j = rng.randrange(size)
        buf[j], x = x, buf[j]
        yield x
    rng.shuffle(buf)
    yield from buf


def decode_jpg_cls(sample: dict) -> tuple[Any, int]:
    """The reference's ``.decode("pil").to_tuple("jpg","cls")``: PIL image +
    integer class (train.py:84)."""
    from PIL import Image

    img_bytes = None
    for ext in ("jpg", "jpeg", "png", "ppm"):
        if ext in sample:
            img_bytes = sample[ext]
            break
    if img_bytes is None:
        raise KeyError("no image entry in sample")
    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    cls = int(sample.get("cls", b"-1").decode()) if isinstance(sample.get("cls"), bytes) \
        else int(sample.get("cls", -1))
    return img, cls
