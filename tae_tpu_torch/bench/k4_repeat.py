"""Reproducer of K4's one disagreement with its plain version on the card:
``chip_smoke.py``'s first K4 case, the qkv product (16384, 1024) x
(3072, 1024) + bias in bf16 (128 x 128 tiles, no K split), run many times,
each in a fresh process.

A child process runs ``chip_smoke.py``'s phases in their order up to that
case: the device, the build, the K1 and K2 cases, then the int8 kernel
phase with its K3 cases. So the case sees the smoke run's inputs, its
earlier launches and allocations. Where the phase makes the qkv call, the
child calls K4 ``--repeats`` times more and the plain version
(``int8_matmul_reference``, an fp64 product) twice, stops, and prints one
JSON line: the worst difference from the plain version against
``chip_smoke.py``'s bf16 bound (1e-2 + 1e-2 relative), which repeats differ
from the first output bit for bit, whether the two plain runs agree, and
where the off elements lie, as a block tile (``Tiles`` BM x BN), one
warp's fragment of it, or scattered.

The parent runs ``--fresh`` children one after another, each right after
the build directory of the present sources is removed (so the child builds
the library and the qkv case is the first K4 call of that build), then the
rest of ``--runs`` children, ``--parallel`` at a time; it writes every
child's line to ``--out`` and prints the counts. ``--sanitize``, between
the two, runs the K4 cases of the CUDA tests (``pytest
tests/test_torch_cuda.py -k "int8 or tiles"``) under ``compute-sanitizer``
with each of racecheck, synccheck and initcheck, and prints each tool's
exit code, its own report lines and the end of the run (the whole report
beside ``--out``, or that the toolkit has no sanitizer).

Run on a machine with a CUDA card, from the repository root::

    python -m tae_tpu_torch.bench.k4_repeat --runs 200 --fresh 4 \\
        --parallel 8 --sanitize --budget_s 1200 --out k4_repeat.jsonl
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROWS, WIDTH = 64 * 256, 1024   # KERNEL_BATCH x 256 tokens, p16's width
ATOL = RTOL = 1e-2             # chip_smoke.py TOL["bfloat16"]
SANITIZERS = ("racecheck", "synccheck", "initcheck")
# the K4 cases of the CUDA tests, under the sanitizer (tests/conftest.py
# needs jax, which a card's machine may lack)
SANITIZED_TESTS = ("--noconftest", "tests/test_torch_cuda.py", "-k",
                   "int8 or tiles")


class _Stop(Exception):
    """Raised once the qkv case is recorded: the rest of the phase is not
    needed."""


def where_off(off, m: int, n: int, k: int) -> dict:
    """The off elements' pattern over K4's tiles at this shape."""
    import torch

    from tae_tpu_torch.ops.cuda.int8_matmul import (MATMUL_TILES, _sms,
                                                    matmul_tiles)

    tile, splits = matmul_tiles(m, n, k, _sms(torch.device("cuda")), False)
    bm, bn = MATMUL_TILES[tile]
    # the warps of a block tile: 2 x 4 of 64 x 32 (128 x 128, 64 x 128
    # tiles: 32 x 32), 1 x 2 of 16 x 32 (16 x 64), int8_matmul.cu
    wm, wn = {0: (64, 32), 1: (32, 32), 2: (16, 32)}[tile]
    rows, cols = (t.tolist() for t in torch.nonzero(off, as_tuple=True))
    tiles = collections.Counter((r // bm, c // bn) for r, c in zip(rows, cols))
    warps = {(r // wm, c // wn) for r, c in zip(rows, cols)}
    if not rows:
        kind = "none"
    elif len(warps) == 1:
        kind = "warp fragment"
    elif len(tiles) <= 2:
        kind = "block tile"
    else:
        kind = "scattered"
    return {"count": len(rows), "kind": kind, "tile": [bm, bn],
            "splits": splits, "tiles_off": len(tiles), "warps_off": len(warps),
            "largest_tile_share": (max(tiles.values()) / (bm * bn)
                                   if tiles else 0.0),
            "first": [[r, c] for r, c in zip(rows[:8], cols[:8])]}


def child(repeats: int) -> int:
    """``chip_smoke.py``'s phases in its order up to K4's qkv case (the
    device, the library's build and load, K1 and K2, K3's cases), the qkv
    case recorded where the phase makes its first K4 call."""
    import torch

    import chip_smoke
    from tae_tpu_torch.bench import rows_body
    from tae_tpu_torch.ops.cuda import build, int8_matmul

    fused, line = int8_matmul.int8_matmul_fused, {}

    def qkv_case(*args):
        first = fused(*args)
        xq, wq = args[0], args[2]
        if tuple(xq.shape) != (ROWS, WIDTH) or tuple(wq.shape) != (3 * WIDTH,
                                                                    WIDTH):
            return first
        again = [fused(*args) for _ in range(repeats)]
        want = int8_matmul.int8_matmul_reference(*args)
        want2 = int8_matmul.int8_matmul_reference(*args)
        torch.cuda.synchronize()
        err = (first.float() - want.float()).abs()
        off = err > ATOL + RTOL * want.float().abs()
        m, k, n = xq.shape[0], xq.shape[1], wq.shape[0]
        line.update(
            pid=os.getpid(), rows=m,
            seconds_to_qkv=time.perf_counter() - t0,
            max_abs_err=float(err.max()), off_plain=where_off(off, m, n, k),
            repeats=repeats,
            repeats_differ=[i + 1 for i, y in enumerate(again)
                            if not torch.equal(y, first)],
            plain_runs_equal=bool(torch.equal(want, want2)))
        for y in again:
            if not torch.equal(y, first):
                line.setdefault("repeat_patterns", []).append(
                    where_off(y != first, m, n, k))
        raise _Stop

    # the wrapper counts its launches on the module's name, now this one
    qkv_case.launches = 0
    int8_matmul.int8_matmul_fused = qkv_case
    # K3's cases build the empty kernel's library: each child its own, as
    # children run at once
    rows_body.empty_library = functools.partial(
        rows_body.empty_library, build.BUILD_ROOT / f"empty-{os.getpid()}")
    t0 = time.perf_counter()
    chip_smoke.phase_device()
    # the build phase's part on the card: the library built (if it is not)
    # and loaded; its reports read the build's log and SASS on the host
    build.build_library()
    build.library()
    chip_smoke.phase_kernels()
    try:
        chip_smoke.phase_int8_kernels()
    except _Stop:
        pass
    if not line:
        print("the int8 kernel phase made no qkv call", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


def run(cmd: list, timeout: int = 300) -> tuple[int, str, str]:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return 124, e.stdout or "", f"killed after {timeout} s"
    return proc.returncode, proc.stdout, proc.stderr


def run_child(repeats: int) -> tuple[int, str, str]:
    return run([sys.executable, "-m", "tae_tpu_torch.bench.k4_repeat",
                "--child", "--repeats", str(repeats)])


def child_line(rc: int, out: str, err: str) -> dict:
    for text in reversed(out.splitlines()):
        if text.startswith("{"):
            return dict(json.loads(text), rc=rc)
    return {"rc": rc, "error": (err or out)[-2000:]}


def sanitize(log: pathlib.Path) -> None:
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = shutil.which("compute-sanitizer")
    if found is None and (home / "bin" / "compute-sanitizer").is_file():
        found = str(home / "bin" / "compute-sanitizer")
    if found is None:
        print("[sanitize] no compute-sanitizer on PATH or under CUDA_HOME/bin")
        return
    for tool in SANITIZERS:
        t = time.perf_counter()
        rc, out, err = run([found, "--tool", tool, "--error-exitcode", "9",
                            sys.executable, "-m", "pytest", "-q", "-x",
                            "-p", "no:cacheprovider", *SANITIZED_TESTS],
                           timeout=900)
        report = (out + err).strip().splitlines()
        with log.open("a") as f:
            f.write(f"==== {tool}: exit {rc}\n" + "\n".join(report) + "\n")
        print(f"[sanitize] {tool} on pytest {' '.join(SANITIZED_TESTS)}: "
              f"exit {rc} in {time.perf_counter() - t:.1f} s (the report in "
              f"{log})")
        # the sanitizer's own lines, and the end of the run
        for text in [x for x in report if x.startswith("=========")][:40] \
                + report[-12:]:
            print(f"[sanitize]   {text[:300]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--repeats", type=int, default=9)
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--fresh", type=int, default=10)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--budget_s", type=float, default=float("inf"),
                    help="start no child past this many seconds of the "
                         "parallel runs")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.child:
        return child(args.repeats)

    from tae_tpu_torch.ops.cuda import build
    from tae_tpu_torch.profile_serving import card_line

    print(card_line(), flush=True)
    lines = []
    build_dir = build.BUILD_ROOT / build.source_hash(build.CSRC_DIR)
    for i in range(args.fresh):
        shutil.rmtree(build_dir, ignore_errors=True)
        lines.append(dict(child_line(*run_child(args.repeats)),
                          fresh_build=True))
        print(f"[fresh {i}] {json.dumps(lines[-1])[:400]}", flush=True)
    if any(x["rc"] != 0 for x in lines):
        print(f"[failed] a child after a fresh build: "
              f"{json.dumps(lines)[-3000:]}")
        return 1
    if args.sanitize:
        sanitize(pathlib.Path(args.out or "k4_repeat.jsonl").with_suffix(
            ".sanitize.log"))
    t = time.perf_counter()

    def budgeted():
        if time.perf_counter() - t > args.budget_s:
            return None
        return run_child(args.repeats)

    with concurrent.futures.ThreadPoolExecutor(args.parallel) as pool:
        futures = [pool.submit(budgeted)
                   for _ in range(args.runs - args.fresh)]
        for f in futures:
            if f.result() is not None:
                lines.append(dict(child_line(*f.result()), fresh_build=False))
    print(f"[runs] {len(lines) - args.fresh} of {args.runs - args.fresh} "
          f"children (none started past {args.budget_s} s), {args.parallel} "
          f"at a time, in {time.perf_counter() - t:.1f} s", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    ran = [x for x in lines if x["rc"] == 0]
    off = [x for x in ran if x["off_plain"]["count"]]
    rep = [x for x in ran if x["repeats_differ"]]
    plain = [x for x in ran if not x["plain_runs_equal"]]
    print(f"[summary] {len(lines)} processes ({args.fresh} after a fresh "
          f"build), {len(ran)} ran to their end; off the plain version: "
          f"{len(off)}; a repeat differing from the first call: {len(rep)}; "
          f"the two plain runs differing: {len(plain)}; worst max_abs_err "
          f"{max((x['max_abs_err'] for x in ran), default=float('nan')):.3g}")
    for x in off + rep:
        print(f"[mismatch] {json.dumps(x)[:1500]}")
    for x in lines:
        if x["rc"] != 0:
            print(f"[failed] {json.dumps(x)[:1500]}")
    return 0 if len(ran) == len(lines) else 1


if __name__ == "__main__":
    sys.exit(main())
