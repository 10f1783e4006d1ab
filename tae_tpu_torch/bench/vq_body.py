"""Time K14's bf16 codebook search (``csrc/quantizer.cu``,
``nearest_code_wgmma_kernel``; plan ``csrc/quantizer.cuh``) at the VQ
paths' shapes against 8192 codes: (16384, 256), (2048, 256) and (256, 256)
latents (``vq_p16`` at B = 64, 8, 1), (1024, 4096) (``vq_p64``, z riding
the ring) and (256, 16384) (the vocab-16384 width), beside its operation
and byte bound and a cuBLAS bf16 product ``z @ c.T`` + ``argmin`` over the
distances (a time-only yardstick: it writes the (M, K) scores). Each
measured the same way: a CUDA graph of 20 calls replayed 7 times, median /
20, the call being the C entry (the norms kernel, the search and, where
the codebook is split, the merge).

* ``--parent DIR``: the search of another checkout (``DIR`` a ``csrc``
  directory, for example of a ``git archive`` of the parent commit) through
  its own C entry and its own launch rule (the rows a block and codebook
  ranges of the ``mma.sync`` design, ``PARENT_PLAN``), in turns with the
  tree's (tree, parent, parent, tree). The ids of both are compared at
  every timed shape and at ragged edges (``EDGES``); the rows that differ
  are counted and each must be a near-tie (the chosen code's squared
  distance, fp64, within 1e-4 relative of the other's).
* variants, built from edited copies of the sources, each timed in turns
  with the tree and its ids compared as the parent's: ``bn256`` (codes a
  tile), ``stages4``, ``stages6`` (ring slots at most), ``cluster2`` (row
  blocks in thread-block clusters of two, each loading half of every
  codebook slab and multicasting it to both: the edits ``CLUSTER2`` put
  that form into the copy), ``one_consumer`` (64-row blocks at every row
  count); and ``no_epilogue``, a diagnostic whose ids are not compared
  (the products and the ring alone: no distances, no running argmin).

Prints the card's name and power limit, ptxas's registers and spills of the
search's instantiations, the library's plan at each timed shape, each
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
from tae_tpu_torch.ops.cuda.quantizer import VqPlan, nearest_code_reference

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
K = 8192
TIMED = ((16384, 256), (2048, 256), (256, 256), (1024, 4096), (256, 16384))
# untimed (m, k, v): rows off a 64- and a 128-row block, codes off a tile,
# widths of one vector, part of a second step, past z's resident widths
EDGES = ((1, 1, 8), (65, 127, 72), (129, 129, 1480), (1000, 777, 1024), (257, 65, 136),
         (4096, 8192, 256), (100, 64, 4096), (33, 70, 16384))
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
    "bn256": [(HEADER, "constexpr int kCodes = 128;", "constexpr int kCodes = 256;")],
    "stages4": [(HEADER, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 4;")],
    "stages6": [(HEADER, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 6;")],
    "cluster2": CLUSTER2,
    "one_consumer": [(HEADER, "constexpr int kMaxConsumers = 2;",
                      "constexpr int kMaxConsumers = 1;")],
    # a diagnostic: no distances or (min, argmin) after a tile's products
    "no_epilogue": [(BODY, "      for (int j = 0; j < BN / 8; ++j) {\n        const float2 nn",
                     "      for (int j = 0; j < BN / 8 && m < 0; ++j) {\n        const float2 nn")],
}
# variants whose ids are not compared
DIAGNOSTICS = {"no_epilogue"}


def parent_plan(m: int, v: int, k: int, sms: int) -> tuple[int, int]:
    """(rows a block, codebook ranges) of the mma.sync design's wrapper:
    the largest of 128, 64, 32 rows whose z stays resident beside its
    4-stage ring and still gives every SM a block (32 where none does);
    ranges for about two blocks an SM where the row blocks are fewer than
    the SMs, at most one a 64-code tile."""
    ring = 4 * 64 * 72 * 2
    fits = [bm for bm in (128, 64, 32)
            if bm * (-(-v // 64) * 64 + 8) * 2 + ring <= 232448] or [128, 64, 32]
    bm = next((b for b in fits if -(-m // b) >= sms), fits[-1])
    blocks = -(-m // bm)
    splits = 1 if blocks >= sms else max(1, min(-(-k // 64), -(-2 * sms // blocks)))
    return bm, splits


def lib_plan(lib, m: int, v: int, k: int, sms: int) -> VqPlan:
    out = (ctypes.c_int * 10)()
    build.check(lib.tae_nearest_code_plan(m, v, k, sms, out), "tae_nearest_code_plan")
    return VqPlan(*out[1:])


def caller(lib, z, cb, sms: int, parent: bool):
    """A call of ``lib``'s C entry on (z, cb): ids (M,). Holds its inputs
    and workspaces (the graph replays their addresses)."""
    (m, v), k = z.shape, cb.shape[0]
    if parent:
        rows, splits = parent_plan(m, v, k, sms)
        kp, arg = k, rows
    else:
        plan = lib_plan(lib, m, v, k, sms)
        splits, kp, arg = plan.splits, -(-k // plan.codes) * plan.codes, sms
    norms = torch.empty(kp, dtype=torch.float32, device="cuda")
    ws = torch.empty(2 * splits * m, dtype=torch.float32, device="cuda") if splits > 1 else None
    out = torch.empty(m, dtype=torch.int64, device="cuda")

    def call():
        build.check(lib.tae_nearest_code_fwd(
            z.data_ptr(), cb.data_ptr(), norms.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, v, k, 1, arg, splits, stream()),
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
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}")
    ap.add_argument("--parent", default=None, help="csrc directory of another checkout")
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
    for m, v in TIMED:
        cases.append((m, K, v, True))
    for m, k, v in EDGES:
        cases.append((m, k, v, False))
    data = []
    for m, k, v, timed in cases:
        z = torch.randn((m, v), generator=gen, device="cuda").bfloat16()
        cb = torch.randn((k, v), generator=gen, device="cuda").bfloat16()
        data.append((m, k, v, timed, z, cb))

    # the tree alone: plan, time, bound, plain version, yardstick
    base = []
    for m, k, v, timed, z, cb in data:
        call = caller(tree, z, cb, sms, parent=False)
        ids = call().clone()
        torch.cuda.synchronize()
        n, near = compare_ids(z, cb, ids, nearest_code_reference(z, cb))
        base.append(ids)
        line = (f"[tree] ({m}, {v}) x ({k}, {v}): plan {lib_plan(tree, m, v, k, sms)}; "
                f"ids differ from the plain version's on {n} rows (near-ties: {near})")
        if timed:
            ops = 2.0 * m * k * v
            nbytes = 2 * (m * v + k * v) + 8 * m
            bnd = max(ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            by = "operations" if ops / BF16_OPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
            cn = (cb.float() ** 2).sum(-1)
            prod = lambda: torch.matmul(z, cb.t())                               # noqa: E731
            yard = lambda: torch.argmin(cn - 2.0 * torch.matmul(z, cb.t()).float(), dim=1)  # noqa: E731
            line += (f"; kernel {time_ms(call):.4f} ms, bound {bnd:.4f} ms ({by}), plain "
                     f"{time_ms(lambda: nearest_code_reference(z, cb)):.4f} ms, cuBLAS bf16 "
                     f"z @ c.T {time_ms(prod):.4f} ms, + argmin {time_ms(yard):.4f} ms")
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
            other = caller(lib, z, cb, sms, parent=name == "parent")
            theirs = other().clone()
            torch.cuda.synchronize()
            n, near = compare_ids(z, cb, mine, theirs)
            ok &= near or name in DIAGNOSTICS
            line = f"[{name}] ({m}, {v}) x ({k}, {v})"
            if name != "parent":
                line += f" plan {lib_plan(lib, m, v, k, sms)}"
            if timed:
                mine_call = caller(tree, z, cb, sms, parent=False)
                times = {0: [], 1: []}
                for side, fn in ((0, mine_call), (1, other), (1, other), (0, mine_call)):
                    times[side].append(time_ms(fn))
                line += (f": tree {statistics.mean(times[0]):.4f} ms ({times[0][0]:.4f}, "
                         f"{times[0][1]:.4f}), {name} {statistics.mean(times[1]):.4f} ms "
                         f"({times[1][0]:.4f}, {times[1][1]:.4f})")
            print(f"{line}; ids differ on {n} rows (near-ties: {near})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
