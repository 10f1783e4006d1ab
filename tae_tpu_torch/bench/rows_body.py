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

With ``--dtype fp32`` the float32 forms instead: the flat-row body's
``rows_attention_f32`` (K6 and K9 at the same shapes; K7 / K8 below 33
tokens) and K7 / K8 from 33 tokens on the tiled fp32 forward body
(``attention_q8_f32_tiled``) at p16's (64, 256, 3072) h16 and p32's (64,
64, 6144) h32, each beside K2 in fp32 at the same shape (K7 / K8's
yardstick with the plain quantize, which the chip smoke run times), at the
edges ``F32_EDGES`` untimed (K6 / K9 as ``EDGES``; K7 and K8 at 32 and 33
tokens, either side of the rule). With ``--parent`` every fp32 output must
equal the parent's bit for bit (both keep the first design's sums); the
variants ``f32_hpb2`` and ``f32_hpb8`` (``kF32HeadsPerBlock``) are compared
too, as are ``f32_q8_cluster8`` (K7 / K8 from 33 tokens in clusters of up to
8 blocks, ``kF32MaxCluster``, so 2 heads a block at 16 heads) and
``f32_q8_regs255`` (that int8 form at one block an SM and up to 255
registers at every head count) and ``f32_q8_rows`` (K7 / K8 on the
flat-row body at every token count up to 64); the
diagnostics ``f32_no_scores`` (no Q.K^T products), ``f32_no_pv``
(no P.V products) and ``f32_no_staging`` (no cp.async of K and V) are not.

Prints the card's name and power limit, ptxas's registers and spills of
the body's instantiations, the library's plan at each timed shape with the
clusters (K9) or blocks (K6) the card holds at once, and each entry's time.

    python -m tae_tpu_torch.bench.rows_body [--dtype fp32] [--parent DIR] [variant ...]

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
# float32: (batch, tokens, heads, head dim) of K7 / K8 timed, and of the
# edges compared untimed (K6 / K9 at EDGES, K7 / K8 either side of the rule)
F32_Q8 = (("K7", 64, 256, 16, 64), ("K8", 64, 64, 32, 64))
F32_EDGES = (("K7", 3, 32, 16, 64), ("K7", 3, 33, 16, 64), ("K8", 3, 32, 32, 80),
             ("K8", 3, 33, 32, 80), ("K7", 2, 255, 5, 80), ("K8", 2, 17, 48, 64))
F32_KERNELS = ("rows_attention_f32", "attention_q8_f32_tiled")
# variant -> ([(file of csrc/, text, replacement), ...], outputs compared)
VARIANTS = {
    **{f"f32_hpb{k}": ([("rows_attention.cuh", "constexpr int kF32HeadsPerBlock = 4;",
                         f"constexpr int kF32HeadsPerBlock = {k};")], True) for k in (2, 8)},
    "f32_q8_regs255": ([("flash_attention.cu",
                         "__launch_bounds__(kTThreads, TWO ? 2 : 1)",
                         "__launch_bounds__(kTThreads, 1)")], True),
    "f32_q8_rows": ([("flash_attention.cu",
                      "  if (n < kF32TiledMinTokens || n > kMaxN || heads < 1 || heads > 65535 ||",
                      "  if (n <= 64 || n > kMaxN || heads < 1 || heads > 65535 ||")], True),
    "f32_q8_cluster8": ([("attention_q8.cuh", "constexpr int kF32MaxCluster = 16;",
                          "constexpr int kF32MaxCluster = 8;")], True),
    "f32_no_scores": ([("wide_attention.cu", "      for (int d = 0; d < DH; d += 4) {\n"
                        "        const float4 k0", "      for (int d = 0; d < 0; d += 4) {\n"
                        "        const float4 k0")], False),
    "f32_no_pv": ([("wide_attention.cu", "      for (int kw = 0; kw < wn; ++kw) {",
                    "      for (int kw = 0; kw < 0; ++kw) {")], False),
    "f32_no_staging": ([("wide_attention.cu",
                         "      stage_rows_f32<DH>(head + c, row_stride, w_lo, wn, k_hi, ks, lane);\n"
                         "      stage_rows_f32<DH>(head + 2 * c, row_stride, w_lo, wn, k_hi, vs, lane);\n",
                         "")], False),
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


def ptxas_report(build_dir: pathlib.Path, fp32: bool = False) -> list[str]:
    """ptxas's registers and spills of rows_attention_bf16<dh, mode> (mode
    0 exact, 1 serving, 2 int8 output), or with ``fp32`` of
    rows_attention_f32<dh, mode> and attention_q8_f32_tiled<dh>."""
    out, entry = [], ""
    kernel = "rows_attention_f32" if fp32 else "rows_attention_bf16"
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            continue
        if "spill" not in line and "registers" not in line:
            continue
        m = re.search(kernel + r"ILi(\d+)ELi(\d)E", entry)
        t = re.search(r"attention_q8_f32_tiledILi(\d+)E", entry) if fp32 else None
        if m:
            mode = ("exact", "serving", "int8")[int(m.group(2))]
            out.append(f"{kernel} dh {m.group(1)} {mode}: {line.split(':', 1)[-1].strip()}")
        elif t:
            out.append(f"attention_q8_f32_tiled dh {t.group(1)}: "
                       f"{line.split(':', 1)[-1].strip()}")
    return out


def cases(gen, fp32: bool = False):
    """(label, call(lib) -> outputs, bound ms or None, timed) for every
    entry and shape, in bf16 or (``fp32``) float32; ``call`` allocates its
    outputs and launches on the current stream. The inputs stay referenced
    by the calls."""
    out = []
    dtype = torch.float32 if fp32 else torch.bfloat16
    code, el = (0, 4) if fp32 else (1, 2)

    def k9(x, rows, n, h, dh):
        def call(lib):
            q = torch.empty((rows, h * dh), dtype=torch.int8, device="cuda")
            s = torch.empty((rows, 1), dtype=torch.float32, device="cuda")
            build.check(lib.tae_wide_attention_q8_2d_fwd(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                                   rows, n, h, dh, dh ** -0.5, code, stream()),
                  "K9")
            return q, s
        return call

    def k6(x, b, n, h, dh, serving):
        def call(lib):
            y = torch.empty((b, n, h * dh), dtype=dtype, device="cuda")
            build.check(lib.tae_wide_attention_fwd(x.data_ptr(), y.data_ptr(), b, n, h, dh,
                                             dh ** -0.5, int(serving), code, stream()), "K6")
            return (y,)
        return call

    def k7(x, b, n, h, dh, entry="tae_packed_attention_q8_fwd"):
        def call(lib):
            q = torch.empty((b, n, h * dh), dtype=torch.int8, device="cuda")
            s = torch.empty((b, n, 1), dtype=torch.float32, device="cuda")
            build.check(getattr(lib, entry)(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                            b, n, h, dh, dh ** -0.5, code, stream()), entry)
            return q, s
        return call

    def k2(x, b, n, h, dh):
        def call(lib):
            y = torch.empty((b, n, h * dh), dtype=dtype, device="cuda")
            build.check(lib.tae_packed_attention_fwd(x.data_ptr(), y.data_ptr(), b, n, h, dh,
                                               dh ** -0.5, 1, code, stream()), "K2")
            return (y,)
        return call

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    c = H * DH
    tag = " fp32" if fp32 else ""
    for rows in ROWS:
        b = rows // N
        x = randn((b, N, 3 * c))
        in_bytes = x.numel() * el
        out.append((f"K9 ({rows}, {3 * c}) n {N} h{H} dh{DH}{tag}", k9(x, rows, N, H, DH),
                    (in_bytes + rows * c + rows * 4) / HBM_BYTES_PER_S * 1e3, True))
        for serving in (True, False):
            out.append((f"K6 {'serving' if serving else 'exact'} ({b}, {N}, {3 * c}){tag}",
                        k6(x, b, N, H, DH, serving),
                        (in_bytes + rows * c * el) / HBM_BYTES_PER_S * 1e3, True))
        out.append((f"K2 serving ({b}, {N}, {3 * c}){tag}", k2(x, b, N, H, DH), None, True))
    if fp32:
        for kind, b, n, h, dh in F32_Q8 + F32_EDGES:
            x = randn((b, n, 3 * h * dh))
            entry = ("tae_packed_attention_q8_fwd" if kind == "K7"
                     else "tae_wide_attention_q8_fwd")
            timed = b == 64
            # operations: the fp32 rate bounds these shapes (4 N dh a row and head)
            ops_ms = 4.0 * b * h * n * n * dh / 67e12 * 1e3
            out.append((f"{kind} ({b}, {n}, {3 * h * dh}) h{h} dh{dh} fp32", k7(x, b, n, h, dh, entry),
                        ops_ms if timed else None, timed))
            if timed:
                out.append((f"K2 serving ({b}, {n}, {3 * h * dh}) fp32", k2(x, b, n, h, dh),
                            None, True))
    for b, n, h, dh in EDGES:
        x = randn((b, n, 3 * h * dh))
        out.append((f"K9 edge ({b * n}, {3 * h * dh}) n {n} h{h} dh{dh}{tag}",
                    k9(x, b * n, n, h, dh), None, False))
        for serving in (True, False):
            out.append((f"K6 edge {'serving' if serving else 'exact'} ({b}, {n}, {3 * h * dh})"
                        f" h{h} dh{dh}{tag}", k6(x, b, n, h, dh, serving), None, False))
    for b, n, h, dh in () if fp32 else K7_WIDE:
        x = randn((b, n, 3 * h * dh))
        out.append((f"K7 past 32 heads ({b}, {n}, {3 * h * dh}) h{h} dh{dh}",
                    k7(x, b, n, h, dh), None, False))
    return out


def plan_entry(fp32: bool) -> str:
    return "tae_rows_attention_f32_plan" if fp32 else "tae_rows_attention_plan"


def print_plans(tag: str, lib, fp32: bool = False) -> None:
    """The library's plan at p128's shape (absent from a parent's library)."""
    if not hasattr(lib, plan_entry(fp32)):
        return
    for q8 in (1, 0):
        out = (ctypes.c_int * 7)()
        build.check(getattr(lib, plan_entry(fp32))(N, H, DH, q8, out), plan_entry(fp32))
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
    fp32 = False
    if "--dtype" in argv:
        i = argv.index("--dtype")
        fp32, argv = argv[i + 1] == "fp32", argv[:i] + argv[i + 2:]
    default = [v for v in VARIANTS if v.startswith("f32_") == fp32]
    names = (["parent"] if parent else []) + (argv or ([] if parent else default))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    tree = build.library()
    for line in ptxas_report(build.BUILD_ROOT / build.source_hash(), fp32):
        print(f"[tree] {line}")
    print_plans("tree", tree, fp32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = cases(gen, fp32)
    base = run_all(tree, runs)

    empty = empty_library()
    plan = (ctypes.c_int * 7)()
    build.check(getattr(tree, plan_entry(fp32))(N, H, DH, 1, plan), plan_entry(fp32))
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
            for line in ptxas_report(build_dir, fp32):
                print(f"[{name}] {line}")
            print_plans(name, lib, fp32)
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
                    line += f", bound {bnd:.4f} ms"
            if same is not None:
                line += f"; outputs bit-equal: {same}"
            print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
