"""Time K14's codebook search (``csrc/quantizer.cu``; plans
``csrc/quantizer.cuh``) at the VQ paths' shapes against 8192 codes. bf16
(``nearest_code_wgmma_kernel``): (16384, 256), (2048, 256) and (256, 256)
latents (``vq_p16`` at B = 64, 8, 1), (1024, 4096) (``vq_p64``, z riding
the ring) and (256, 16384) (the vocab-16384 width), beside a cuBLAS bf16
product ``z @ c.T`` + ``argmin`` over the distances (a time-only
yardstick: it writes the (M, K) scores). fp32 (``nearest_code_f32_kernel``,
the CUDA cores, no TF32): (256, 256), (2048, 256) and (16384, 256), beside
``torch.cdist`` + ``argmin``. Each beside its operation and byte bound
(989 TFLOP/s bf16, 67 TFLOP/s fp32) and its plain version, measured the
same way: a CUDA graph of 20 calls replayed 7 times, median / 20, the call
being the C entry (the norms kernel, the search and, where the codebook is
split, the merge).

* ``--parent DIR``: the search of another checkout (``DIR`` a ``csrc``
  directory, for example of a ``git archive`` of the parent commit) through
  its own C entry and its own plans (an fp32 search without a plan entry
  takes the whole codebook in one range), in turns with the tree's (tree,
  parent, parent, tree). The ids of both are compared at every timed shape
  and at ragged edges (``EDGES``, ``F32_EDGES``, among them split and
  riding shapes); the rows that differ are counted. fp32 ids must be equal
  on every row (both add the same products in the same order); a bf16 row
  that differs must be a near-tie (the chosen code's squared distance,
  fp64, within 1e-4 relative of the other's).
* variants, built from edited copies of the sources, each timed in turns
  with the tree and its ids compared as the parent's: ``bn256`` (codes a
  tile), ``stages4``, ``stages6`` (ring slots at most), ``cluster2`` (row
  blocks in thread-block clusters of two, each loading half of every
  codebook slab and multicasting it to both: the edits ``CLUSTER2`` put
  that form into the copy), ``one_consumer`` (64-row blocks at every row
  count); ``f32_stages2`` (the fp32 ring at two slots), ``f32_narrow``
  (128-code tiles, 8 x 8 a thread, at every shape), ``f32_unroll2`` (the
  fp32 column loop unrolled by 2); and the
  diagnostics, whose ids are not compared: ``no_epilogue`` (the bf16
  products and the ring alone: no distances, no running argmin),
  ``f32_no_epilogue`` (the fp32 search without its distances and running
  argmin).

Prints the card's name and power limit, ptxas's registers and spills of the
searches' instantiations, the library's plan at each timed shape, each
timing beside its bound, its plain version's and the yardstick's.

    python -m tae_tpu_torch.bench.vq_body [--parent DIR] [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import argparse
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
from tae_tpu_torch.ops.cuda.quantizer import (VqF32Plan, VqPlan,
                                              nearest_code_reference)

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
K = 8192
TIMED = ((16384, 256), (2048, 256), (256, 256), (1024, 4096), (256, 16384))
F32_TIMED = ((256, 256), (2048, 256), (16384, 256))
# untimed (m, k, v): rows off a 64- and a 128-row block, codes off a tile,
# widths of one vector, part of a second step, past z's resident widths
EDGES = ((1, 1, 8), (65, 127, 72), (129, 129, 1480), (1000, 777, 1024), (257, 65, 136),
         (4096, 8192, 256), (100, 64, 4096), (33, 70, 16384))
# fp32: one row, code and vector; rows and codes off the 128 tiles and a
# width off the 32-column chunk; the codebook split at few rows; z riding
# the ring past 352 columns
F32_EDGES = ((1, 1, 4), (129, 129, 36), (127, 8192, 260), (300, 777, 1024),
             (33, 70, 16384), (4097, 129, 356))
NEAR_TIE_RTOL = 1e-4
HEADER = "quantizer.cuh"
BODY = "quantizer.cu"
# The search with its row blocks in clusters of two along grid.x (the grid
# rounded up to an even count; a block past the last row loads zeros and
# writes nothing): each block loads half of every codebook slab and
# multicasts it to both, and a slot is free once the consumers of both
# blocks have released it.
CLUSTER2 = [
    (HEADER, "  p.blocks = ceil_div(m, p.rows);\n",
     "  p.blocks = round_up(ceil_div(m, p.rows), 2);\n"),
    (BODY, "      mbar_init(&empty[s], NC);  // each consumer warpgroup\n",
     "      mbar_init(&empty[s], 2 * NC);  // each consumer warpgroup of the pair\n"),
    (BODY, "    mbar_init_fence();\n  }\n  __syncthreads();\n",
     "    mbar_init_fence();\n  }\n  cluster_sync();  // the peer's barriers are ready\n"),
    (BODY, "        tma_load_2d(slot, &cmap, &full[stage], ks * kCols, code0);\n",
     "        const unsigned rank = cluster_rank();\n"
     "        tma_load_2d_multicast(slot + rank * (kCSlab / 2), &cmap, &full[stage],\n"
     "                              ks * kCols, code0 + static_cast<int>(rank) * (BN / 2), 3);\n"),
    (BODY, "      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);\n",
     "      if (threadIdx.x % 128 == 0) {\n"
     "        mbar_arrive_cluster(&empty[s], 0);\n"
     "        mbar_arrive_cluster(&empty[s], 1);\n"
     "      }\n"),
    (BODY, "          ws_i[static_cast<long>(blockIdx.y) * m + r] = best_i[h];\n"
           "        }\n      }\n    }\n  }\n}\n",
     "          ws_i[static_cast<long>(blockIdx.y) * m + r] = best_i[h];\n"
     "        }\n      }\n    }\n  }\n"
     "  cluster_sync();  // no block leaves while its peer may arrive on its barriers\n}\n"),
    (BODY, "  kernel<<<dim3(p.blocks, p.splits), NC * 128 + 32, p.smem, stream>>>(\n"
           "      zmap, cmap, cn, out, ws_d, ws_i, m, v, k, p.per, p.stages);\n"
           "  return static_cast<int>(cudaGetLastError());\n",
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3(p.blocks, p.splits);\n"
     "  cfg.blockDim = dim3(NC * 128 + 32);\n"
     "  cfg.dynamicSmemBytes = p.smem;\n"
     "  cfg.stream = stream;\n"
     "  cudaLaunchAttribute attr;\n"
     "  attr.id = cudaLaunchAttributeClusterDimension;\n"
     "  attr.val.clusterDim.x = 2;\n"
     "  attr.val.clusterDim.y = 1;\n"
     "  attr.val.clusterDim.z = 1;\n"
     "  cfg.attrs = &attr;\n"
     "  cfg.numAttrs = 1;\n"
     "  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, zmap, cmap, cn, out, ws_d,\n"
     "                                              ws_i, m, v, k, p.per, p.stages));\n"),
    (BODY, "  rc = tensor_map_bf16_2d(&cmap, cb, v, k, row_bytes, vq::kCols, p.codes);\n",
     "  rc = tensor_map_bf16_2d(&cmap, cb, v, k, row_bytes, vq::kCols, p.codes / 2);\n"),
]
VARIANTS = {
    "bn256": [(HEADER, "constexpr int kCodes = 128;        // codes of a tile: the wgmma's N",
               "constexpr int kCodes = 256;        // codes of a tile: the wgmma's N")],
    "stages4": [(HEADER, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 4;")],
    "stages6": [(HEADER, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 6;")],
    "cluster2": CLUSTER2,
    "one_consumer": [(HEADER, "constexpr int kMaxConsumers = 2;",
                      "constexpr int kMaxConsumers = 1;")],
    "f32_stages2": [(HEADER, "constexpr int kMaxStages = 4;    // ring slots, at most",
                     "constexpr int kMaxStages = 2;    // ring slots, at most")],
    "f32_unroll2": [(BODY, "#pragma unroll 1\n    for (int c = 0; c < kChunk; c += 4) {",
                     "#pragma unroll 2\n    for (int c = 0; c < kChunk; c += 4) {")],
    "f32_narrow": [(HEADER, "  p.codes = p.blocks * ceil_div(k, kWideCodes) >= sms ? kWideCodes : kCodes;\n",
                    "  p.codes = kCodes;\n")],
    # a diagnostic: the fp32 search without its distances and running argmin
    # (skipped at run time, so the products stay)
    "f32_no_epilogue": [(BODY, "    if (ch == chunks - 1) {", "    if (ch == chunks - 1 && m < 0) {")],
    # a diagnostic: no distances or (min, argmin) after a tile's products
    "no_epilogue": [(BODY, "      for (int j = 0; j < BN / 8; ++j) {\n        const float2 nn",
                     "      for (int j = 0; j < BN / 8 && m < 0; ++j) {\n        const float2 nn")],
}
# variants whose ids are not compared
DIAGNOSTICS = {"no_epilogue", "f32_no_epilogue"}


def lib_plan(lib, m: int, v: int, k: int, sms: int, dtype) -> VqPlan | VqF32Plan | None:
    """``lib``'s plan for the dtype, None for an fp32 search without one."""
    out = (ctypes.c_int * 10)()
    if dtype == torch.bfloat16:
        build.check(lib.tae_nearest_code_plan(m, v, k, sms, out), "tae_nearest_code_plan")
        return VqPlan(*out[1:])
    if not hasattr(lib, "tae_nearest_code_f32_plan"):
        return None
    build.check(lib.tae_nearest_code_f32_plan(m, v, k, sms, out), "tae_nearest_code_f32_plan")
    return VqF32Plan(*out[1:])


def caller(lib, z, cb, sms: int):
    """A call of ``lib``'s C entry on (z, cb): ids (M,). Holds its inputs
    and workspaces (the graph replays their addresses)."""
    (m, v), k = z.shape, cb.shape[0]
    plan = lib_plan(lib, m, v, k, sms, z.dtype)
    splits = 1 if plan is None else plan.splits
    kp = -(-k // plan.codes) * plan.codes if z.dtype == torch.bfloat16 else k
    norms = torch.empty(kp, dtype=torch.float32, device="cuda")
    ws = torch.empty(2 * splits * m, dtype=torch.float32, device="cuda") if splits > 1 else None
    out = torch.empty(m, dtype=torch.int64, device="cuda")
    code = build.dtype_code(z.dtype)

    def call():
        build.check(lib.tae_nearest_code_fwd(
            z.data_ptr(), cb.data_ptr(), norms.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, v, k, code, sms, splits, stream()),
            "tae_nearest_code_fwd")
        return out
    return call


def compare_ids(z, cb, mine, theirs) -> tuple[int, bool]:
    """(rows whose ids differ, whether each is a near-tie)."""
    off = mine != theirs
    n = int(off.sum())
    if n == 0:
        return 0, True
    zz, c = z[off].double(), cb.double()
    d1 = (zz - c[mine[off]]).square().sum(-1)
    d2 = (zz - c[theirs[off]]).square().sum(-1)
    near = bool((d1 <= d2 * (1 + NEAR_TIE_RTOL) + 1e-12).all()
                and (d2 <= d1 * (1 + NEAR_TIE_RTOL) + 1e-12).all())
    return n, near


def ptxas_report(build_dir) -> list[str]:
    out, entry = [], ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "nearest_code_wgmma_kernel" in entry and ("spill" in line or "registers" in line
                                                       or "C75" in line):
            m = re.search(r"kernelILi(\d)ELb(\d)E", entry)
            out.append(f"<consumers {m.group(1)}, z {'rides' if m.group(2) == '1' else 'resident'}>"
                       f": {line.split(':', 1)[-1].strip()}")
        elif "nearest_code_f32_kernel" in entry and ("spill" in line or "registers" in line):
            m = re.search(r"kernelILb(\d)E", entry)
            out.append(f"fp32 <z {'resident' if m.group(1) == '1' else 'rides'}>"
                       f": {line.split(':', 1)[-1].strip()}")
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}")
    ap.add_argument("--parent", default=None, help="csrc directory of another checkout")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default=None,
                    help="only this dtype's shapes (default: both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tree = build.library()
    for line in ptxas_report(build.BUILD_ROOT / build.source_hash()):
        print(f"[tree] {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    if args.dtype != "fp32":
        cases += [(m, K, v, torch.bfloat16, True) for m, v in TIMED]
        cases += [(m, k, v, torch.bfloat16, False) for m, k, v in EDGES]
    if args.dtype != "bf16":
        cases += [(m, K, v, torch.float32, True) for m, v in F32_TIMED]
        cases += [(m, k, v, torch.float32, False) for m, k, v in F32_EDGES]
    data = []
    for m, k, v, dtype, timed in cases:
        z = torch.randn((m, v), generator=gen, device="cuda").to(dtype)
        cb = torch.randn((k, v), generator=gen, device="cuda").to(dtype)
        data.append((m, k, v, timed, z, cb))

    def shape(m, k, v, z):
        return f"({m}, {v}) x ({k}, {v}) {'bf16' if z.dtype == torch.bfloat16 else 'fp32'}"

    # the tree alone: plan, time, bound, plain version, yardstick
    base = []
    for m, k, v, timed, z, cb in data:
        call = caller(tree, z, cb, sms)
        ids = call().clone()
        torch.cuda.synchronize()
        n, near = compare_ids(z, cb, ids, nearest_code_reference(z, cb))
        base.append(ids)
        line = (f"[tree] {shape(m, k, v, z)}: plan {lib_plan(tree, m, v, k, sms, z.dtype)}; "
                f"ids differ from the plain version's on {n} rows (near-ties: {near})")
        if timed:
            ops = 2.0 * m * k * v
            nbytes = z.element_size() * (m * v + k * v) + 8 * m
            t_ops, t_bytes = ops / OPS_PER_S[z.dtype], nbytes / HBM_BYTES_PER_S
            bnd, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            line += (f"; kernel {time_ms(call):.4f} ms, bound {bnd * 1e3:.4f} ms ({by}), plain "
                     f"{time_ms(lambda: nearest_code_reference(z, cb)):.4f} ms")
            if z.dtype == torch.bfloat16:
                cn = (cb.float() ** 2).sum(-1)
                prod = lambda: torch.matmul(z, cb.t())                           # noqa: E731
                yard = lambda: torch.argmin(cn - 2.0 * torch.matmul(z, cb.t()).float(),  # noqa: E731
                                            dim=1)
                line += (f", cuBLAS bf16 z @ c.T {time_ms(prod):.4f} ms, + argmin "
                         f"{time_ms(yard):.4f} ms")
            else:
                yard = lambda: torch.cdist(z, cb).argmin(dim=-1)                 # noqa: E731
                line += f", torch.cdist + argmin {time_ms(yard):.4f} ms"
        print(line, flush=True)

    ok = True
    names = (["parent"] if args.parent else []) + args.variants
    for name in names:
        if name == "parent":
            lib = build.load(build.build_library(build.BUILD_ROOT / "parent",
                                                 pathlib.Path(args.parent)))
        else:
            lib, lib_dir = build_variant(f"vq_{name}", VARIANTS[name])
            for line in ptxas_report(lib_dir):
                print(f"[{name}] {line}")
        for (m, k, v, timed, z, cb), mine in zip(data, base):
            other = caller(lib, z, cb, sms)
            theirs = other().clone()
            torch.cuda.synchronize()
            n, near = compare_ids(z, cb, mine, theirs)
            # fp32 adds the same products in the same order: equal ids
            ok &= name in DIAGNOSTICS or (n == 0 if z.dtype == torch.float32 else near)
            line = (f"[{name}] {shape(m, k, v, z)} plan "
                    f"{lib_plan(lib, m, v, k, sms, z.dtype)}")
            if timed:
                mine_call = caller(tree, z, cb, sms)
                times = {0: [], 1: []}
                for side, fn in ((0, mine_call), (1, other), (1, other), (0, mine_call)):
                    times[side].append(time_ms(fn))
                line += (f": tree {statistics.mean(times[0]):.4f} ms ({times[0][0]:.4f}, "
                         f"{times[0][1]:.4f}), {name} {statistics.mean(times[1]):.4f} ms "
                         f"({times[1][0]:.4f}, {times[1][1]:.4f})")
            print(f"{line}; ids differ on {n} of {m} rows (near-ties: {near})", flush=True)
    print("every comparison held" if ok else "a comparison failed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
