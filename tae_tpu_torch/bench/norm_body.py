"""Time the LayerNorm row kernels: K3 ``ln_quant`` (``csrc/int8_block.cu``)
at p128's width, (M, 2560) bf16 at M = 256, 32 and 4 (B = 64, 8, 1), and at
p16's (16384, 1024), beside an empty kernel launched on K3's grid; K11, the
LayerNorm backward (``csrc/layernorm.cu``), at (16384, 1024) in bf16 and
fp32 and at ``p128_train``'s (32, 2560); and K1, the LayerNorm forward, at
(M, 2560), M = 256 / 32 / 4, and (16384, 1024), its stats form (y, mean,
rstd) at (32, 2560) and (16384, 1024), beside its bound and the library
call (``F.layer_norm``, ``aten.native_layer_norm``). Each measured the same
way: a CUDA graph of 20 launches replayed 7 times, median / 20.

* ``--parent DIR``: the kernels of another checkout (``DIR`` a ``csrc``
  directory, for example of a ``git archive`` of the parent commit),
  through their own C entries, in turns with the tree's (tree, parent,
  parent, tree). K3's codes and scales and K11's dx must equal the parent's
  bit for bit at every timed shape and at the edge shapes (``K3_EDGES``,
  ``K11_EDGES``: widths 8, 264, 4096 and past each register body, rows
  that leave a block or a chunk part-filled), K11's dw and db too where
  both chunk the rows alike (from 16384 rows; below, the tree spreads the
  rows over more chunks and the largest difference is printed), K1's y,
  mean and rstd in both entries too (``K1_EDGES``: widths 8, 264, 4096,
  4104, fp32 rows whose 4-column vectors leave a lane's last 8-column group
  half-filled). The SASS of K4's and K5's finish passes
  (``int8_matmul_finish_kernel``, ``int8_mlp_finish_kernel``, which run the
  first design's ``ln_quant_row``) and of K1's first design
  (``layer_norm_fwd_kernel``, which rows past 4096 columns still run) must
  be the parent's.
* variants, built from edited copies of the sources: ``loop`` (no register
  body: K3 through the first design's runtime loop on the new launch plan,
  K11 through the first design's three launches), ``warps1``, ``warps2``,
  ``warps4`` (K3 with that many warps a block at every row count), whose
  outputs must equal the tree's; ``chunk64`` (K11 in chunks of 64 rows:
  twice the blocks), whose dx must equal the tree's and whose dw / db may
  differ in fp32 summation order (the largest difference is printed);
  ``no_prefetch`` (K11 without its L2 prefetch of rows ahead), ``l2ahead3``
  / ``l2ahead4`` / ``l2ahead6`` (that prefetch 3, 4 or 6 rows ahead, not
  2); ``affine_late`` (K3 reading gamma and beta at the affine step at
  every width), ``finish32`` (K11's finish loading 32 chunks at once, not
  64), ``k1_loop`` (K1 through its first design's runtime loop on the new
  launch plan: the loop kernel's rows a block taken from its launch); and
  diagnostics whose outputs are not compared: ``k3_stats_only``
  (K3 stops once it has the row's statistics: the loads, the two sums and
  their reductions), ``k11_no_finish`` (K11 without its finish launch).

Prints the card's name and power limit, ptxas's registers and spills of
K3's, K1's and K11's register-body instantiations, the library's plans at each
timed shape, each kernel's time beside its bound, its plain version's and
the library call's (``F.layer_norm``, its backward), and a fingerprint of
the finish passes' SASS (what ``chip_smoke.py`` holds them to).

    python -m tae_tpu_torch.bench.norm_body [--parent DIR] [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import re
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from tae_tpu_torch.bench.attention_body import time_ms
from tae_tpu_torch.bench.int4_body import sass_functions
from tae_tpu_torch.bench.int8_body import build_variant, stream
from tae_tpu_torch.bench.rows_body import empty_library
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int8_block import ln_quant_plan, ln_quant_reference
from tae_tpu_torch.ops.cuda.layernorm import bwd_row_chunks
from tae_tpu_torch.ops.layernorm import (layer_norm_backward_reference,
                                         layer_norm_reference,
                                         layer_norm_stats_reference)

HBM_BYTES_PER_S = 3.35e12
P128_ROWS = (256, 32, 4)
EPS = 1e-6
BF16, F32 = torch.bfloat16, torch.float32
# untimed shapes compared with the parent and the variants: (rows, cols,
# dtype); widths 8 and 264 (one group, part of a second), 4096 (K3's widest
# register row), 4104 and 2568 (past K3's and K11's register bodies), rows
# off a block of 4 warps and a chunk of 128 rows
K3_EDGES = ((1, 8, BF16), (129, 264, BF16), (1001, 1024, F32), (7, 2048, BF16),
            (3, 4096, BF16), (5, 4104, BF16), (130, 2568, F32))
K11_EDGES = ((1, 8, BF16), (129, 264, BF16), (1001, 2560, BF16), (512, 2048, BF16),
             (2048, 1024, F32), (129, 2560, F32), (7, 4096, BF16), (130, 2568, BF16))
# K1's untimed shapes, each through both entries: one group, part of a
# second, fp32 rows whose 4-column vectors end inside a lane's 8-column
# group (264, 1032, 2568), p128's width in fp32, the widest register row
# and the first width past it (the first design), rows off a block
K1_EDGES = ((1, 8, BF16), (1, 8, F32), (129, 264, BF16), (129, 264, F32), (7, 1032, F32),
            (1001, 2560, F32), (130, 2568, F32), (5, 4096, BF16), (5, 4096, F32),
            (3, 4104, BF16), (3, 4104, F32))
# the kernels whose SASS the tree must share with the parent
SAME_SASS = ("int8_matmul_finish_kernel", "int8_mlp_finish_kernel", "layer_norm_fwd_kernel")
# the register bodies' instantiations, for ptxas's report
BODIES = ("ln_quant_regs_kernel", "layer_norm_fwd_rows_kernel", "layer_norm_bwd_rows_kernel")

HEADER = "row_norm.cuh"
# variant -> ([(file of csrc/, text, replacement), ...], what is compared:
# "all" outputs, or "dx" only)
VARIANTS = {
    "loop": ([(HEADER, "constexpr int kLnqMaxNv = 16;", "constexpr int kLnqMaxNv = 0;"),
              (HEADER, "constexpr int kBwdMaxNv = 10;", "constexpr int kBwdMaxNv = 0;")],
             "all"),
    **{f"warps{k}": ([(HEADER, "constexpr int kLnqMaxWarps = 4;",
                       f"constexpr int kLnqMaxWarps = {k};"),
                      (HEADER, "  while (warps > 1 && rows < static_cast<long>(warps) * "
                               "kLnqMinBlocks) warps /= 2;\n", "")], "all")
      for k in (1, 2, 4)},
    "chunk64": ([(HEADER, "constexpr int kBwdRowsPerChunk = 128;",
                  "constexpr int kBwdRowsPerChunk = 64;")], "dx"),
    "no_prefetch": ([("layernorm.cu",
                      "    prefetch_l2(r + tae::rownorm::kBwdL2Ahead * kBwdWarps);\n", "")],
                    "all"),
    **{f"l2ahead{k}": ([(HEADER, "constexpr int kBwdL2Ahead = 2;",
                         f"constexpr int kBwdL2Ahead = {k};")], "all") for k in (3, 4, 6)},
    # K3 with gamma and beta read at the affine step at every width
    "affine_late": ([(HEADER, "  return nv > 4 && nv * 4 * (x_bytes + w_bytes) <= 160;",
                      "  return false;")], "all"),
    # K11's finish loading 32 chunks at once, not 64
    "finish32": ([("layernorm.cu", "  constexpr int kBatch = 64;",
                   "  constexpr int kBatch = 32;")], "all"),
    # K1's first design (its runtime loop) on the register body's launch plan
    "k1_loop": ([(HEADER, "constexpr int kFwdMaxNv = 16;", "constexpr int kFwdMaxNv = 0;"),
                 ("layernorm.cu",
                  "  const long row = static_cast<long>(blockIdx.x) * kWarpsPerBlock + warp;\n"
                  "  if (row >= rows) return;\n  const T* xr = x + row * cols;\n"
                  "  T* yr = y + row * cols;",
                  "  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) + warp;\n"
                  "  if (row >= rows) return;\n  const T* xr = x + row * cols;\n"
                  "  T* yr = y + row * cols;"),
                 ("layernorm.cu",
                  "<<<(rows + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32, 0, stream>>>(",
                  "<<<p.blocks, p.warps * 32, 0, stream>>>(")],
                "all"),
    # diagnostics, outputs not compared: K11 without its finish launch
    "k11_no_finish": ([("layernorm.cu",
                        "  if (rc != 0) return rc;\n  layer_norm_bwd_finish_kernel<W>",
                        "  if (rc != 0 || rows > 0) return rc;\n  layer_norm_bwd_finish_kernel<W>")],
                      None),
    # a diagnostic, outputs not compared: K3 writes rstd as the scale once
    # the statistics are known (the loads, the two sums and their
    # reductions), no affine, max or codes
    "k3_stats_only": ([("int8_block.cu",
                        "  // max|y| is exact in any order: a tree over the lane's groups",
                        "  if (lane == 0) s[row] = rstd;\n  if (rows > 0) return;\n"
                        "  // max|y| is exact in any order: a tree over the lane's groups")],
                      None),
}
# the first design's chunks of K11's column sums (the parent's library has
# no plan entry): 128 rows a chunk, more where there would be over 1024
FIRST_ROWS_PER_CHUNK, FIRST_MAX_CHUNKS = 128, 1024


def first_design_chunks(rows: int) -> tuple[int, int]:
    per = max(FIRST_ROWS_PER_CHUNK, -(-rows // FIRST_MAX_CHUNKS))
    return -(-rows // per), per


def demangle(names: list[str]) -> list[str]:
    """Kernel names through the toolkit's cu++filt (the mangled names where
    it is missing)."""
    tool = pathlib.Path(build.find_nvcc()).parent / "cu++filt"
    if not tool.is_file():
        return names
    out = subprocess.run([str(tool)], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(build_dir: pathlib.Path) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill bytes) of each register-body instantiation."""
    found, entry = {}, ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif any(b in entry for b in BODIES):
            regs = re.findall(r"Used (\d+) registers", line)
            spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            cur = found.setdefault(entry, [0, 0])
            if regs:
                cur[0] = int(regs[0])
            cur[1] += sum(map(int, spills))
    names = demangle(list(found))
    return sorted((re.sub(r">\(.*", ">", n).replace("void <unnamed>::", ""), *found[e])
                  for n, e in zip(names, found))


def sass_fingerprints(lib_path: pathlib.Path) -> dict[str, str]:
    """sha256 (16 hex digits) of each SAME_SASS kernel's SASS, its
    instructions only (no addresses or encodings), all its instantiations
    in name order: what chip_smoke.py's FINISH_SASS holds."""
    funcs = sass_functions(lib_path, SAME_SASS)
    out = {}
    for kernel in SAME_SASS:
        h = hashlib.sha256()
        for name in sorted(n for n in funcs if kernel in n):
            for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", funcs[name]):
                h.update(ins.encode())
        out[kernel] = h.hexdigest()[:16]
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(*tensors) -> float:
    return nbytes(*tensors) / HBM_BYTES_PER_S * 1e3


def cases(gen, tree):
    """(label, kind, call(lib) -> outputs, bound ms or None, timed, rows);
    call allocates its outputs and launches on the current stream. The
    inputs stay referenced by the calls. kind: "k3", "k11" (outputs dx, dw,
    db) or "k1"."""
    out = []

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    def k3(m, d, dtype, timed):
        x = randn((m, d), dtype, 3.0, 1.0)
        g, b = randn((d,), dtype, 0.5, 1.0), randn((d,), dtype, 0.2)

        def call(lib):
            q = torch.empty((m, d), dtype=torch.int8, device="cuda")
            s = torch.empty((m, 1), dtype=F32, device="cuda")
            build.check(lib.tae_ln_quant_fwd(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                                             q.data_ptr(), s.data_ptr(), m, d, EPS,
                                             build.dtype_code(dtype), build.dtype_code(dtype),
                                             stream()), "K3")
            return q, s
        call.plain = lambda: ln_quant_reference(x, g, b, EPS)
        call.library = None
        bnd = bound_ms(x, g, b) + (m * d + 4 * m) / HBM_BYTES_PER_S * 1e3
        name = str(dtype).split(".")[1]
        out.append((f"K3 ({m}, {d}) {name}", "k3", call, bnd, timed, m))

    def k11(m, d, dtype, timed):
        x = randn((m, d), dtype, 3.0, 1.0)
        w, b = randn((d,), dtype, 1.0, 1.0), randn((d,), dtype)
        dy = randn((m, d), dtype)
        mean = torch.empty(m, dtype=F32, device="cuda")
        rstd = torch.empty(m, dtype=F32, device="cuda")
        y = torch.empty_like(x)
        build.check(tree.tae_layer_norm_fwd_stats(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), m, d, EPS, build.dtype_code(dtype), build.dtype_code(dtype),
            stream()), "K1 stats")

        def call(lib):
            plan = lib_bwd_plan(lib, m, d)
            dx = torch.empty_like(x)
            dw, db = torch.empty_like(w), torch.empty_like(w)
            part = torch.empty((2, plan[0], d), dtype=F32, device="cuda")
            build.check(lib.tae_layer_norm_bwd(
                x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(), m, d, plan[0],
                plan[1], build.dtype_code(dtype), build.dtype_code(dtype), stream()), "K11")
            return dx, dw, db
        call.plain = lambda: layer_norm_backward_reference(x, w, mean, rstd, dy)
        _, lm, lr = torch.ops.aten.native_layer_norm(x, [d], w, b, EPS)
        call.library = lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [d], lm, lr, w, b, [True, True, True])
        bnd = bound_ms(x, w, mean, rstd, dy, x, w, w)   # and dx, dw, db written
        name = str(dtype).split(".")[1]
        out.append((f"K11 ({m}, {d}) {name}", "k11", call, bnd, timed, m))

    def k1(m, d, dtype, timed, stats=False):
        x = randn((m, d), dtype, 3.0, 1.0)
        w, b = randn((d,), dtype, 1.0, 1.0), randn((d,), dtype)
        code = build.dtype_code(dtype)

        def call(lib):
            y = torch.empty_like(x)
            if not stats:
                build.check(lib.tae_layer_norm_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                   y.data_ptr(), m, d, EPS, code, code,
                                                   stream()), "K1")
                return (y,)
            mean = torch.empty(m, dtype=F32, device="cuda")
            rstd = torch.empty(m, dtype=F32, device="cuda")
            build.check(lib.tae_layer_norm_fwd_stats(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), m, d, EPS, code, code, stream()), "K1 stats")
            return y, mean, rstd
        if stats:
            call.plain = lambda: layer_norm_stats_reference(x, w, b, EPS)
            call.library = lambda: torch.ops.aten.native_layer_norm(x, [d], w, b, EPS)
            bnd = bound_ms(x, w, b, x) + 8 * m / HBM_BYTES_PER_S * 1e3
        else:
            call.plain = lambda: layer_norm_reference(x, w, b, EPS)
            call.library = lambda: F.layer_norm(x, (d,), w, b, EPS)
            bnd = bound_ms(x, w, b, x)
        name = str(dtype).split(".")[1]
        form = " stats" if stats else ""
        out.append((f"K1{form} ({m}, {d}) {name}", "k1", call, bnd, timed, m))

    for m in P128_ROWS:
        k3(m, 2560, BF16, True)
    k3(16384, 1024, BF16, True)
    for m, d, dtype in K3_EDGES:
        k3(m, d, dtype, False)
    k11(16384, 1024, BF16, True)
    k11(16384, 1024, F32, True)
    k11(32, 2560, BF16, True)
    for m, d, dtype in K11_EDGES:
        k11(m, d, dtype, False)
    for m in P128_ROWS:
        k1(m, 2560, BF16, True)
    k1(32, 2560, BF16, True, stats=True)
    k1(16384, 1024, BF16, True)
    k1(16384, 1024, BF16, True, stats=True)
    for m, d, dtype in K1_EDGES:
        k1(m, d, dtype, False)
        k1(m, d, dtype, False, stats=True)
    return out


def lib_bwd_plan(lib, rows: int, cols: int) -> tuple[int, int]:
    """(chunks, rows a chunk) that ``lib``'s K11 takes: its own plan where
    it has a plan entry (the tree's, a variant's), else the first design's
    (the parent's library)."""
    if hasattr(lib, "tae_layer_norm_bwd_plan"):
        out = (ctypes.c_int * 8)()
        build.check(lib.tae_layer_norm_bwd_plan(rows, cols, out), "tae_layer_norm_bwd_plan")
        return out[2], out[3]
    return first_design_chunks(rows)


def print_plans(tag: str, lib) -> None:
    """The library's plans at the timed shapes (absent from a parent's)."""
    if not hasattr(lib, "tae_ln_quant_plan"):
        return
    for m, d in [(m, 2560) for m in P128_ROWS] + [(16384, 1024)]:
        out = (ctypes.c_int * 4)()
        build.check(lib.tae_ln_quant_plan(m, d, out), "tae_ln_quant_plan")
        print(f"[{tag}] K3 plan ({m}, {d}): nv {out[1]}, {out[2]} warps a block, "
              f"{out[3]} blocks", flush=True)
    for m, d in [(m, 2560) for m in P128_ROWS] + [(16384, 1024), (5, 4104)]:
        if hasattr(lib, "tae_layer_norm_fwd_plan"):
            out = (ctypes.c_int * 4)()
            build.check(lib.tae_layer_norm_fwd_plan(m, d, out), "tae_layer_norm_fwd_plan")
            print(f"[{tag}] K1 plan ({m}, {d}): nv {out[1]}, {out[2]} warps a block, "
                  f"{out[3]} blocks", flush=True)
    for m, d in ((16384, 1024), (32, 2560), (1001, 2560)):
        out = (ctypes.c_int * 8)()
        build.check(lib.tae_layer_norm_bwd_plan(m, d, out), "tae_layer_norm_bwd_plan")
        print(f"[{tag}] K11 plan ({m}, {d}): nv {out[1]}, {out[2]} chunks of {out[3]} rows "
              f"x {out[7]} column slices, {out[4]} warps, sums in "
              f"{'registers' if out[5] else 'shared memory'}, {out[6]} bytes of shared memory",
              flush=True)


def run_all(lib, runs):
    """Every case's outputs from ``lib``, synchronized and cloned."""
    res = []
    for _, _, call, _, _, _ in runs:
        outs = call(lib)
        torch.cuda.synchronize()
        res.append([t.clone() for t in outs])
    return res


def compare(kind: str, what, mine, theirs) -> tuple[bool, str]:
    """(whether the compared outputs are bit-equal, a note)."""
    if what is None:
        return True, "a diagnostic: outputs not compared"
    if what == "dx" and kind == "k11":
        same = torch.equal(mine[0], theirs[0])
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(mine[1:], theirs[1:]))
        return same, f"dx bit-equal: {same}; dw / db max |diff| {diff:.3g}"
    same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    return same, f"outputs bit-equal: {same}"


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="csrc directory of another checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    names = (["parent"] if args.parent else []) + (
        args.variants or ([] if args.parent else list(VARIANTS)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    tree = build.library()
    tree_dir = build.BUILD_ROOT / build.source_hash()
    for kernel, regs, spill in ptxas_report(tree_dir):
        print(f"[tree] {kernel}: {regs} registers, {spill} bytes spilled")
    print_plans("tree", tree)
    print(f"[tree] SASS fingerprints {sass_fingerprints(tree_dir / build.LIB_NAME)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = cases(gen, tree)
    base = run_all(tree, runs)

    empty = empty_library()
    for m in P128_ROWS + (16384,):
        plan = ln_quant_plan(m, 2560 if m in P128_ROWS else 1024)
        ms = time_ms(lambda: build.check(
            empty.tae_empty_launch(plan.blocks, 1, 32 * plan.warps, 1, stream()), "empty"))
        print(f"[tree] empty kernel on K3's grid at {m} rows ({plan.blocks} blocks of "
              f"{32 * plan.warps} threads): {ms:.4f} ms", flush=True)
    # each timed kernel beside its plain version and the one library call
    # that computes the same function (F.layer_norm, its backward)
    for label, kind, call, bnd, timed, _ in runs:
        if timed:
            lib_ms = "none" if call.library is None else f"{time_ms(call.library):.4f} ms"
            print(f"[tree] {label}: kernel {time_ms(lambda: call(tree)):.4f} ms, bound "
                  f"{bnd:.4f} ms (bytes), plain {time_ms(call.plain):.4f} ms, library "
                  f"{lib_ms}", flush=True)

    ok = True
    for name in names:
        if name == "parent":
            lib_dir = build.BUILD_ROOT / "parent" / build.source_hash(args.parent)
            lib = build.load(build.build_library(build.BUILD_ROOT / "parent", args.parent))
            what = "all"
            mine_fp = sass_fingerprints(tree_dir / build.LIB_NAME)
            theirs_fp = sass_fingerprints(lib_dir / build.LIB_NAME)
            for kernel in SAME_SASS:
                same = mine_fp[kernel] == theirs_fp[kernel]
                ok &= same
                print(f"[sass] {kernel}: {'identical to' if same else 'DIFFERENT from'} "
                      f"the parent's ({mine_fp[kernel]} / {theirs_fp[kernel]})", flush=True)
        else:
            lib, lib_dir = build_variant(name, VARIANTS[name][0])
            what = VARIANTS[name][1]
            for kernel, regs, spill in ptxas_report(lib_dir):
                print(f"[{name}] {kernel}: {regs} registers, {spill} bytes spilled")
            print_plans(name, lib)
        other = run_all(lib, runs)
        for (label, kind, call, bnd, timed, rows), mine, theirs in zip(runs, base, other):
            # the parent chunks K11's rows as the first design: where the
            # tree chunks them otherwise, its dw / db differ in fp32 order
            alike = name != "parent" or bwd_row_chunks(rows) == first_design_chunks(rows)
            same, note = compare(kind, what if alike else "dx", mine, theirs)
            ok &= same
            line = f"[{name}] {label}"
            if timed:
                times = {0: [], 1: []}
                for k, which in ((0, tree), (1, lib), (1, lib), (0, tree)):
                    times[k].append(time_ms(lambda: call(which)))
                line += (f": tree {statistics.mean(times[0]):.4f} ms ({times[0][0]:.4f}, "
                         f"{times[0][1]:.4f}), {name} {statistics.mean(times[1]):.4f} ms "
                         f"({times[1][0]:.4f}, {times[1][1]:.4f}), bound {bnd:.4f} ms (bytes)")
            print(f"{line}; {note}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
