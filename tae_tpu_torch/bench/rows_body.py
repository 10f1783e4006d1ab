"""Time the flat-row attention body (``rows_attention_bf16`` in
``csrc/wide_attention.cu``: K6 ``fused_qkv_attention_wide`` and K9
``fused_qkv_attention_wide_q8_2d``, bf16) at p128's shape, 4 tokens, 32
heads of 80, at 256, 32 and 4 flat rows (B = 64, 8, 1), beside K2 at the
same shape (the per-image body with a bf16 output) and an empty kernel
launched on K9's grid, with and without its cluster: each measured the
same way, a CUDA graph of 20 launches replayed 7 times, median / 20.

* ``--parent DIR``: the kernels of another checkout (``DIR`` a ``csrc``
  directory, for example of a ``git archive`` of the parent commit),
  through their own C entries, in turns with the tree's (tree, parent,
  parent, tree); K9's codes and scales and K6's bf16 output in both softmax
  forms must equal the parent's bit for bit at every timed shape and at the
  edge shapes (``EDGES``: token counts that do and do not divide a 16-row
  tile, chunked key ranges, head counts whose last group takes fewer heads,
  rows that leave a tile part-filled; K7 past 32 heads, which runs here).
* variants, built from edited copies of the sources: ``hpb1``, ``hpb2``
  and ``hpb8`` (``tae::rows::kHeadsPerBlock`` 1, 2 and 8 instead of 4: K6
  in groups of that many heads; K9 at 32 heads in clusters of 16 blocks of
  2 (``hpb1``: 2 is the fewest 16 blocks take), or of 4 blocks of 8), whose
  outputs must equal the tree's; diagnostics whose outputs are wrong and not
  compared: ``no_exchange`` (each block scales with its own heads' maxima, a
  block barrier for the first cluster barrier and none for the second, no
  distributed shared memory), ``no_cluster`` (the same launched without a
  cluster), ``no_fold`` (each lane sums its own p: no shuffles for the row
  sums in key order).

Prints the card's name and power limit, ptxas's registers and spills of
the body's instantiations, the library's plan at each timed shape with the
clusters (K9) or blocks (K6) the card holds at once, and each entry's time.

    python -m tae_tpu_torch.bench.rows_body [--parent DIR] [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

import torch

from tae_tpu_torch.bench.attention_body import time_ms
from tae_tpu_torch.bench.int8_body import build_variant, stream
from tae_tpu_torch.ops.cuda import build

N, H, DH = 4, 32, 80            # p128: tokens, heads, head dim
ROWS = (256, 32, 4)             # p128's flat rows at B = 64, 8, 1
HBM_BYTES_PER_S = 3.35e12
# (batch, tokens, heads, head dim) compared with the parent, untimed
EDGES = ((7, 1, 3, 64), (7, 3, 17, 80), (5, 5, 3, 64), (9, 8, 17, 64), (3, 12, 2, 80),
         (5, 16, 48, 64), (3, 24, 3, 80), (2, 40, 3, 64), (3, 63, 5, 80), (2, 64, 32, 64))
# K7 past 32 heads (tokens above 64: chunked keys), compared with the parent
K7_WIDE = ((2, 100, 48, 64), (1, 256, 36, 80))

NO_EXCHANGE = [("const float* pm = cluster.map_shared_rank(block_max, r);",
                "const float* pm = block_max;"),
               ("cluster.sync();  // every rank's block maxima", "__syncthreads();  //"),
               ('asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");', ""),
               ('asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");', "")]
# variant -> ([(file of csrc/, text, replacement), ...], outputs compared)
VARIANTS = {
    **{f"hpb{k}": ([("rows_attention.cuh", "constexpr int kHeadsPerBlock = 4;",
                     f"constexpr int kHeadsPerBlock = {k};")], True) for k in (1, 2, 8)},
    "no_exchange": ([("wide_attention.cu", *e) for e in NO_EXCHANGE], False),
    "no_cluster": ([("wide_attention.cu", *e) for e in NO_EXCHANGE]
                   + [("wide_attention.cu", "cfg.numAttrs = MODE == kQ8 ? 1 : 0;",
                       "cfg.numAttrs = 0;")], False),
    "no_fold": ([("wide_attention.cu",
                  "          const int from = (lane & ~3) | src;\n"
                  "          const float a = __shfl_sync(0xffffffffu, s[j][e], from);\n"
                  "          const float b = __shfl_sync(0xffffffffu, s[j][2 + e], from);\n",
                  "          const float a = src == 0 ? s[j][e] : 0.f;\n"
                  "          const float b = src == 0 ? s[j][2 + e] : 0.f;\n")], False),
}

# An empty kernel, launched on a given grid with or without a cluster along
# grid.y: the floor under a launch of that shape.
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int tae_empty_launch(int gx, int gy, int threads, int cluster, void* stream) {
  static bool prepared = false;
  if (!prepared) {
    cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    prepared = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""


def empty_library() -> ctypes.CDLL:
    out = build.BUILD_ROOT / "empty"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_SOURCE)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([build.find_nvcc(), *flags, "-shared", "-o", str(out / "libempty.so"),
                    str(out / "empty.cu")], check=True, timeout=600)
    lib = ctypes.CDLL(str(out / "libempty.so"))
    lib.tae_empty_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tae_empty_launch.restype = ctypes.c_int
    return lib


def ptxas_report(build_dir: pathlib.Path) -> list[str]:
    """ptxas's registers and spills of rows_attention_bf16<dh, mode> (mode
    0 exact, 1 serving, 2 int8 output)."""
    out, entry = [], ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            continue
        m = re.search(r"rows_attention_bf16ILi(\d+)ELi(\d)E", entry)
        if m and ("spill" in line or "registers" in line):
            mode = ("exact", "serving", "int8")[int(m.group(2))]
            out.append(f"rows_attention_bf16 dh {m.group(1)} {mode}: "
                       f"{line.split(':', 1)[-1].strip()}")
    return out


def cases(gen):
    """(label, call(lib) -> outputs, bound ms or None, timed) for every
    entry and shape; ``call`` allocates its outputs and launches on the
    current stream. The inputs stay referenced by the calls."""
    out = []

    def k9(x, rows, n, h, dh):
        def call(lib):
            q = torch.empty((rows, h * dh), dtype=torch.int8, device="cuda")
            s = torch.empty((rows, 1), dtype=torch.float32, device="cuda")
            build.check(lib.tae_wide_attention_q8_2d_fwd(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                                   rows, n, h, dh, dh ** -0.5, 1, stream()),
                  "K9")
            return q, s
        return call

    def k6(x, b, n, h, dh, serving):
        def call(lib):
            y = torch.empty((b, n, h * dh), dtype=torch.bfloat16, device="cuda")
            build.check(lib.tae_wide_attention_fwd(x.data_ptr(), y.data_ptr(), b, n, h, dh,
                                             dh ** -0.5, int(serving), 1, stream()), "K6")
            return (y,)
        return call

    def k7(x, b, n, h, dh):
        def call(lib):
            q = torch.empty((b, n, h * dh), dtype=torch.int8, device="cuda")
            s = torch.empty((b, n, 1), dtype=torch.float32, device="cuda")
            build.check(lib.tae_packed_attention_q8_fwd(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                                  b, n, h, dh, dh ** -0.5, 1, stream()), "K7")
            return q, s
        return call

    def k2(x, b, n, h, dh):
        def call(lib):
            y = torch.empty((b, n, h * dh), dtype=torch.bfloat16, device="cuda")
            build.check(lib.tae_packed_attention_fwd(x.data_ptr(), y.data_ptr(), b, n, h, dh,
                                               dh ** -0.5, 1, 1, stream()), "K2")
            return (y,)
        return call

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    c = H * DH
    for rows in ROWS:
        b = rows // N
        x = randn((b, N, 3 * c))
        in_bytes = x.numel() * 2
        out.append((f"K9 ({rows}, {3 * c}) n {N} h{H} dh{DH}", k9(x, rows, N, H, DH),
                    (in_bytes + rows * c + rows * 4) / HBM_BYTES_PER_S * 1e3, True))
        for serving in (True, False):
            out.append((f"K6 {'serving' if serving else 'exact'} ({b}, {N}, {3 * c})",
                        k6(x, b, N, H, DH, serving),
                        (in_bytes + rows * c * 2) / HBM_BYTES_PER_S * 1e3, True))
        out.append((f"K2 serving ({b}, {N}, {3 * c})", k2(x, b, N, H, DH), None, True))
    for b, n, h, dh in EDGES:
        x = randn((b, n, 3 * h * dh))
        out.append((f"K9 edge ({b * n}, {3 * h * dh}) n {n} h{h} dh{dh}",
                    k9(x, b * n, n, h, dh), None, False))
        for serving in (True, False):
            out.append((f"K6 edge {'serving' if serving else 'exact'} ({b}, {n}, {3 * h * dh})"
                        f" h{h} dh{dh}", k6(x, b, n, h, dh, serving), None, False))
    for b, n, h, dh in K7_WIDE:
        x = randn((b, n, 3 * h * dh))
        out.append((f"K7 past 32 heads ({b}, {n}, {3 * h * dh}) h{h} dh{dh}",
                    k7(x, b, n, h, dh), None, False))
    return out


def print_plans(tag: str, lib) -> None:
    """The library's plan at p128's shape (absent from a parent's library)."""
    if not hasattr(lib, "tae_rows_attention_plan"):
        return
    for q8 in (1, 0):
        out = (ctypes.c_int * 7)()
        build.check(lib.tae_rows_attention_plan(N, H, DH, q8, out), "tae_rows_attention_plan")
        print(f"[{tag}] plan n {N} h {H} dh {DH} {'int8' if q8 else 'bf16'}: cluster {out[1]}, "
              f"{out[2]} groups of {out[3]} heads, chunk {out[4]}, {out[5]} bytes; "
              f"{out[6]} {'clusters' if q8 else 'blocks'} at once", flush=True)


def run_all(lib, runs):
    """Every case's outputs from ``lib``, synchronized and cloned."""
    res = []
    for _, call, _, _ in runs:
        outs = call(lib)
        torch.cuda.synchronize()
        res.append([t.clone() for t in outs])
    return res


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent, argv = pathlib.Path(argv[i + 1]), argv[:i] + argv[i + 2:]
    names = (["parent"] if parent else []) + (argv or ([] if parent else list(VARIANTS)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    tree = build.library()
    for line in ptxas_report(build.BUILD_ROOT / build.source_hash()):
        print(f"[tree] {line}")
    print_plans("tree", tree)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = cases(gen)
    base = run_all(tree, runs)

    empty = empty_library()
    plan = (ctypes.c_int * 7)()
    build.check(tree.tae_rows_attention_plan(N, H, DH, 1, plan), "tae_rows_attention_plan")
    groups, threads = plan[2], 32 * plan[3]
    for rows in ROWS:
        tiles = -(-rows // 16)
        for cluster in (1, plan[1]):
            ms = time_ms(lambda: build.check(
                empty.tae_empty_launch(tiles, groups, threads, cluster, stream()), "empty"))
            print(f"[tree] empty kernel on K9's grid ({tiles}, {groups}) x {threads} threads, "
                  f"cluster {cluster}: {ms:.4f} ms", flush=True)

    ok = True
    for name in names:
        if name == "parent":
            lib = build.load(build.build_library(build.BUILD_ROOT / "parent", parent))
            compared = True
        else:
            lib, build_dir = build_variant(name, VARIANTS[name][0])
            compared = VARIANTS[name][1]
            for line in ptxas_report(build_dir):
                print(f"[{name}] {line}")
            print_plans(name, lib)
        other = run_all(lib, runs)
        for (label, call, bnd, timed), mine, theirs in zip(runs, base, other):
            same = None
            if compared and not label.startswith("K2"):
                same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
                ok &= same
            line = f"[{name}] {label}"
            if timed:
                times = {0: [], 1: []}
                for k, which in ((0, tree), (1, lib), (1, lib), (0, tree)):
                    times[k].append(time_ms(lambda: call(which)))
                line += (f": tree {statistics.mean(times[0]):.4f} ms ({times[0][0]:.4f}, "
                         f"{times[0][1]:.4f}), {name} {statistics.mean(times[1]):.4f} ms "
                         f"({times[1][0]:.4f}, {times[1][1]:.4f})")
                if bnd is not None:
                    line += f", bound {bnd:.4f} ms (bytes)"
            if same is not None:
                line += f"; outputs bit-equal: {same}"
            print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
