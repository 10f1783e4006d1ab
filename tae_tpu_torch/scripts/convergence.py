"""The convergence run on the port: ``tae_patch16_vocab16_px256`` trained by
``tae_tpu_torch.cli.train`` over thousands of iterations on the structured
corpus (counterpart of ``scripts/convergence_run.sh``, its data heredoc and
``scripts/convergence_chunks.sh``).

    python -m tae_tpu_torch.scripts.convergence fixture [--workers 8]
    python -m tae_tpu_torch.scripts.convergence run --num_its 5001 \\
        [--chunk_its 1000] [-- --num_workers 6]

``fixture`` writes 24 webdataset shards of 1000 structured images at 288 px
(seeds 0-23) and a 512-image validation ImageFolder (seed 10 000) under
``--root`` (``.convergence/torch`` by default); each shard's bytes depend on
its seed alone, so the shards are written by parallel processes, each to a
temporary name renamed when whole (a shard already in place is kept).

``run`` calls ``cli.train``'s ``main`` with the launcher's flags: batch 64 a
microbatch, 4 microbatches (the reference's global batch 256), lr 1e-4 to
1e-5, no weight decay, an eval and checkpoint every 500 iterations, uint8
batches normalized on the card, remat, reconstruction grids,
``--resume_auto``. With ``--chunk_its`` it runs in chunks, each a fresh
process ending just past a save point; a chunk that fails is tried again
from the last checkpoint, up to three times. Each chunk's wall time
is printed and appended to ``{output_dir}/conv_chunks.jsonl``.

The launcher's ``--num_workers 1`` fed the JAX run from the native
decoder's thread pool on every core. Where the port's drivers decode with
PIL (no libjpeg header), the decoding threads of one process share its
interpreter lock (374 images a second on an H100 host, against the 546 a
step of this run takes: ``bench.train_input``); there, pass
``-- --num_workers 6`` after ``run``'s own flags to spread the decode over
processes (each worker's stream is then its own, as in any multi-worker
run; ``cli.train`` takes the last value of a flag given twice).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

MODEL = "tae_patch16_vocab16_px256"
ROOT = Path(".convergence/torch")
PREFIX = "conv"
SHARDS, SHARD_IMAGES, IMAGE_PX = 24, 1000, 288
VAL_IMAGES, VAL_SEED = 512, 10_000
NUM_ITS, SAVE_FREQ = 5001, 500
ATTEMPTS = 3


# ------------------------------------------------------------------ fixture
def _shard(path: str, num_samples: int, size: int, seed: int) -> str:
    from tae_tpu_torch.data.fake import make_structured_wds_shard

    part = Path(path + ".part")
    make_structured_wds_shard(part, num_samples=num_samples, size=size,
                              seed=seed)
    os.replace(part, path)
    return path


def _val(root: str, num_images: int, size: int, seed: int) -> str:
    import shutil

    from tae_tpu_torch.data.fake import make_structured_imagefolder

    part = Path(root + ".part")
    shutil.rmtree(part, ignore_errors=True)
    make_structured_imagefolder(part, num_images=num_images, size=size,
                                seed=seed)
    os.replace(part, root)
    return root


def fixture(root: Path = ROOT, shards: int = SHARDS,
            samples: int = SHARD_IMAGES, size: int = IMAGE_PX,
            val_images: int = VAL_IMAGES, workers: int = 0) -> Path:
    """The corpus under ``root/data``: ``train-{i:06d}.tar`` for seeds
    0..shards-1 and ``val/class_000``; ``workers`` processes (0: one a
    core). Returns the data directory."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    data = Path(root) / "data"
    data.mkdir(parents=True, exist_ok=True)
    jobs = [(_val, str(data / "val"), val_images, size, VAL_SEED)]
    jobs += [(_shard, str(data / f"train-{i:06d}.tar"), samples, size, i)
             for i in range(shards)]
    jobs = [j for j in jobs if not Path(j[1]).exists()]
    t0 = time.perf_counter()
    workers = min(workers or os.cpu_count() or 1, max(1, len(jobs)))
    if workers == 1:
        for fn, *a in jobs:
            fn(*a)
    else:
        with ProcessPoolExecutor(workers, mp.get_context("spawn")) as pool:
            for f in [pool.submit(fn, *a) for fn, *a in jobs]:
                f.result()
    print(f"[fixture] {len(jobs)} missing of the {shards} shards and the "
          f"val set written under {data} in {time.perf_counter() - t0:.1f} s "
          f"({workers} processes)", flush=True)
    return data


# ---------------------------------------------------------------------- run
def train_argv(root: Path = ROOT, num_its: int = NUM_ITS,
               save_freq: int = SAVE_FREQ, shards: int = SHARDS) -> list[str]:
    """``cli.train``'s flags for the run (``scripts/convergence_run.sh``'s,
    the paths under ``root``)."""
    data = Path(root) / "data"
    return [
        "--model", MODEL,
        "--train_data_path", f"{data}/train-{{000000..{shards - 1:06d}}}.tar",
        "--val_data_path", str(data / "val"),
        "--output_dir", str(Path(root) / "out"),
        "--save_prefix", PREFIX,
        "--batch_size_per_gpu", "64", "--accum_iter", "4",
        "--max_lr", "1e-4", "--min_lr", "1e-5", "--weight_decay", "0.0",
        "--num_its", str(num_its), "--save_freq", str(save_freq),
        "--log_freq", "50",
        "--num_workers", "1", "--device_normalize", "--remat", "--display",
        "--resume_auto"]


def with_flags(argv: list[str], **values) -> list[str]:
    """``argv`` with the value of each ``--name`` in ``values`` replaced
    (appended where ``argv`` lacks the flag)."""
    out = list(argv)
    for name, value in values.items():
        flag = f"--{name}"
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


def chunk_ends(num_its: int, chunk_its: int) -> list[int]:
    """The ``--num_its`` of each chunk: just past every ``chunk_its``-th
    iteration (a save point where ``chunk_its`` is a multiple of the save
    frequency), then ``num_its``."""
    if chunk_its <= 0:
        return [num_its]
    return [e for e in range(chunk_its + 1, num_its, chunk_its)] + [num_its]


def _train_in_process(argv: list[str]) -> None:
    import gc

    from tae_tpu_torch.cli import train

    args = train.get_args_parser().parse_args(argv)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    try:
        train.main(args)
    finally:
        gc.collect()        # the chunk's model, optimizer and graphs


def _train_process(argv: list[str]) -> None:
    done = subprocess.run([sys.executable, "-m", "tae_tpu_torch.cli.train",
                           *argv])
    if done.returncode:
        raise RuntimeError(f"cli.train exited {done.returncode}")


def run(argv: list[str], ends: list[int], in_process: bool = False
        ) -> list[dict]:
    """Train ``argv`` (``--resume_auto`` among its flags) to each of
    ``ends`` in turn, ``--num_its`` set to it; a chunk that raises or exits
    non-zero runs again, from the run's last checkpoint, up to ``ATTEMPTS``
    times. ``in_process``: call ``main`` here, not in a fresh process.
    Returns each chunk's record (``end``, ``attempts``, ``seconds``)."""
    if "--resume_auto" not in argv:
        raise ValueError("a chunked run resumes with --resume_auto")
    out_dir = Path(argv[argv.index("--output_dir") + 1])
    prefix = argv[argv.index("--save_prefix") + 1]
    train_chunk = _train_in_process if in_process else _train_process
    records = []
    for end in ends:
        t0 = time.perf_counter()
        for attempt in range(1, ATTEMPTS + 1):
            try:
                train_chunk(with_flags(argv, num_its=end))
                break
            except Exception as e:      # noqa: BLE001 - retried, then raised
                print(f"[convergence] chunk to {end}, attempt {attempt} "
                      f"failed ({e!r}); again from the last checkpoint",
                      file=sys.stderr, flush=True)
                if attempt == ATTEMPTS:
                    raise SystemExit(f"chunk to {end} failed {ATTEMPTS} "
                                     "times") from e
        rec = {"end": end, "attempts": attempt,
               "seconds": time.perf_counter() - t0}
        records.append(rec)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{prefix}_chunks.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[convergence] chunk to iteration {end - 1}: "
              f"{rec['seconds']:.1f} s, {attempt} attempt(s)", flush=True)
    print("ALLDONE", flush=True)
    return records


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("the convergence run on the port")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fixture", help="write the structured corpus")
    f.add_argument("--root", default=str(ROOT))
    f.add_argument("--workers", default=0, type=int,
                   help="processes writing shards (0: one a core)")
    r = sub.add_parser("run", help="train, in chunks")
    r.add_argument("--root", default=str(ROOT))
    r.add_argument("--num_its", default=NUM_ITS, type=int)
    r.add_argument("--chunk_its", default=0, type=int,
                   help="iterations a chunk (0: one chunk)")
    r.add_argument("train_flags", nargs=argparse.REMAINDER,
                   help="after --: more cli.train flags, appended to the "
                        "launcher's (--num_workers 6, --device cpu, "
                        "--model_args ...)")
    args = p.parse_args(argv)
    if args.cmd == "fixture":
        fixture(Path(args.root), workers=args.workers)
        return
    extra = [a for a in args.train_flags if a != "--"]
    train = train_argv(Path(args.root), args.num_its) + extra
    run(train, chunk_ends(args.num_its, args.chunk_its))


if __name__ == "__main__":
    main()
