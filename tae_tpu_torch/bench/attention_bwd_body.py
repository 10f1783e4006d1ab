"""Time the bf16 attention backward body (K10, K17;
``csrc/flash_attention_bwd.cu``) at the shapes of the paths that run it, as
built and in variants made by replacing text of the source:

* ``warps4``: 4 warps of 16 rows a block instead of 8 (``kTcWarps``), so
  row ranges of 64 rows instead of 128 and twice the blocks; ``kv_regs``:
  the dK/dV warps load their K and V rows once from device memory as A
  fragments held in registers, instead of staging them and reading them by
  ``ldmatrix`` on every query tile; ``noinline_roles``: the two roles as
  functions of their own, not inlined into one kernel body; ``regs255``:
  one block an SM, registers up to 255 a thread (``regs255_dh80`` at dh 80
  only). Their outputs must equal
  the tree's bit for bit: a warp's sums do not depend on which block it is
  in or where its operands come from.
* ``no_exp`` (p = s * scale - lse), ``no_staging`` (no copy of the staged
  operands into shared memory), ``no_delta`` (delta = 0: o is never read,
  what a pre-kernel computing delta once could save at most), ``no_scores``
  (no tensor-core instruction of S and dP), ``no_accumulate`` (none of dV,
  dK, dQ; the compiler then drops the softmax too), ``dq_only`` (the dK/dV
  blocks return at once), ``dkdv_only`` (the dQ blocks do): diagnostics whose
  outputs are wrong and not compared; the differences in time say what each
  part costs inside the whole.
* ``--parent DIR``: the body of another checkout, built from its kernel
  sources (``DIR`` is a ``csrc`` directory, for example of a ``git archive``
  of the parent commit), timed against the tree in the same way; its
  outputs are compared with a tolerance only (another rounding order).

With ``--dtype fp32`` the fp32 bodies instead (``attention_bwd_f32_tiled``
from 56 tokens, the first design ``attention_bwd_f32`` below): the timed
shapes in float32, timed shapes either side of the rule (``F32_RULE``) and
the edges of the tiled body's key chunks and of its rule (``F32_EDGES``,
untimed), against ``--parent`` (whose fp32 outputs must equal the tree's
bit for bit: both keep the first design's order of every sum) or the
variants, all compared bit for bit: ``f32_first`` (the first design at every
token count), ``f32_tiled`` (the tiled body at every token count),
``f32_guarded`` (the guarded instantiation at every token count: what the
unguarded one at 249 / 253 tokens and more saves), ``f32_unroll1`` /
``f32_unroll4`` (the S and dP loop unrolled by 1 / 4 instead of 2),
``f32_kv_unroll8`` (the dK / dV loop by 8 instead of 16), ``f32_dq_unroll2``
(the dQ loop by 2 instead of whole), ``f32_dq_global`` (dQ kept in device
memory between chunks, read and written back by its thread each chunk,
instead of registers); and the diagnostics ``f32_no_scores`` (no S and dP
products), ``f32_no_exp`` (p = s * scale - lse), ``f32_no_dq`` (no dQ
product), ``f32_no_dkdv`` (no dK and dV products), ``f32_no_park`` (the K and
V chunks never stored to shared memory).

Each variant is built from a copy of the sources under ``tae_tpu_torch/_build/``
and loaded beside the tree's library; the two run in turns (tree, variant,
variant, tree) in one process on one card, each timed by the replay of a
CUDA graph of 20 launches (median of 7). Prints the card's name and power
limit and ptxas's report for the body's instantiations.

    python -m tae_tpu_torch.bench.attention_bwd_body [--dtype fp32] [--parent DIR]
        [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys

import torch

from tae_tpu_torch.bench.attention_body import build_variant, ptxas_report, time_ms
from tae_tpu_torch.ops.cuda import build

SOURCE = "flash_attention_bwd.cu"
KERNEL = "attention_bwd_bf16"
# the dK/dV warp's K and V rows as A fragments in registers: no shared
# memory for them, not staged, loaded once from device memory
KV_REGS = [
    ("  const size_t own = 2 * static_cast<size_t>(partition(n).warps) * 16 * ld;",
     "  const size_t own = 0;"),
    ("  bf16* vown = kown + warps * 16 * LD;\n"
     "  float* lse_s = reinterpret_cast<float*>(vown + warps * 16 * LD);",
     "  bf16* vown = kown;\n"
     "  float* lse_s = reinterpret_cast<float*>(vown);"),
    ("    if (c == 0)\n      stage_rows", "    if (false)\n      stage_rows"),
    ("  // K and V rows as A fragments, by ldmatrix from the staged rows\n"
     "  const unsigned kl = a_addr<DH>(kown + warp * 16 * LD, lane);\n"
     "  const unsigned vl = a_addr<DH>(vown + warp * 16 * LD, lane);\n"
     "  auto afrag = [&](int kk, int which, unsigned (&x)[4]) {\n"
     "    tae::ldmatrix_x4_at(x, (which ? vl : kl) + kk * 32);\n"
     "  };",
     "  // K and V rows as A fragments held in registers\n"
     "  unsigned ka[DH / 16][4], va[DH / 16][4];\n"
     "  tae::a_fragments<DH>(ka, [&](int half, int ch) {\n"
     "    const int r = j0 + g + 8 * half;\n"
     "    return active && r < n ? *reinterpret_cast<const uint4*>(kb + r * a.lk.row + ch * 8)\n"
     "                           : make_uint4(0u, 0u, 0u, 0u);\n"
     "  });\n"
     "  tae::a_fragments<DH>(va, [&](int half, int ch) {\n"
     "    const int r = j0 + g + 8 * half;\n"
     "    return active && r < n ? *reinterpret_cast<const uint4*>(vb + r * a.lv.row + ch * 8)\n"
     "                           : make_uint4(0u, 0u, 0u, 0u);\n"
     "  });\n"
     "  auto afrag = [&](int kk, int which, unsigned (&x)[4]) {\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < 4; ++i) x[i] = which ? va[kk][i] : ka[kk][i];\n"
     "  };"),
]
# variant -> ([(text of flash_attention_bwd.cu, its replacement), ...],
# outputs compared with the tree's)
VARIANTS = {
    "warps4": ([("constexpr int kTcWarps = 8;", "constexpr int kTcWarps = 4;")], True),
    "kv_regs": (KV_REGS, True),
    "noinline_roles": ([("__device__ __forceinline__ void dkdv_block",
                         "__device__ __noinline__ void dkdv_block"),
                        ("__device__ __forceinline__ void dq_block",
                         "__device__ __noinline__ void dq_block")], True),
    "regs255": ([("__launch_bounds__(kTcWarps * 32, 2)", "__launch_bounds__(kTcWarps * 32, 1)")],
                True),
    "regs255_dh80": ([("__launch_bounds__(kTcWarps * 32, 2)",
                       "__launch_bounds__(kTcWarps * 32, DH > 64 ? 1 : 2)")], True),
    "no_exp": ([("  p = expf(s * scale - l);", "  p = s * scale - l;")], False),
    "no_staging": ([("      tae::cp_async16(d0, src0 + r * st0 + ch * 8);\n"
                     "      tae::cp_async16(d1, src1 + r * st1 + ch * 8);\n", "")], False),
    "no_scores": ([("    tae::mma_bf16(s[0], a, b[0], b[1]);\n"
                    "    tae::mma_bf16(s[1], a, b[2], b[3]);\n", ""),
                   ("    tae::mma_bf16(dp[0], a, b[0], b[1]);\n"
                    "    tae::mma_bf16(dp[1], a, b[2], b[3]);\n", "")], False),
    "no_accumulate": ([("    tae::mma_bf16(acc[2 * dp], a, b[0], b[1]);\n"
                        "    tae::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);\n", "")], False),
    "no_delta": ([("        if (ch < CH)\n          sum = dot8(", "        if (false)\n          sum = dot8("),
                  ("    delta[half] = dot8(d, *reinterpret_cast<const uint4*>(ob + r * a.lo.row + ch * 8),\n"
                   "                       delta[half]);\n", "")], False),
    "dq_only": ([("    dkdv_block<DH>(a, b, h, x, smem_raw);", "    return;")], False),
    "dkdv_only": ([("    dq_block<DH>(a, b, h, x - ranges, smem_raw);", "    return;")], False),
}
F32_KERNELS = ("attention_bwd_f32_tiled", "attention_bwd_f32")
F32_VARIANTS = {
    "f32_first": ([("constexpr int kF32TiledMinTokens = 56;",
                    "constexpr int kF32TiledMinTokens = 1 << 20;")], True),
    "f32_tiled": ([("constexpr int kF32TiledMinTokens = 56;",
                    "constexpr int kF32TiledMinTokens = 1;")], True),
    "f32_no_scores": ([("    for (int d = 0; d < DH; d += 4) {\n      float4 kv[AK];",
                        "    for (int d = 0; d < 0; d += 4) {\n      float4 kv[AK];")], False),
    "f32_no_exp": ([("          float p = expf(sv - li);", "          float p = sv - li;")],
                   False),
    "f32_no_dq": ([("    for (int j = 0; j < KC; j += 4) {\n      float4 d4[QR];",
                    "    for (int j = 0; j < 0; j += 4) {\n      float4 d4[QR];")], False),
    "f32_no_dkdv": ([("    if (kv_on) {", "    if (false) {")], False),
    "f32_no_park": ([("    park();\n    __syncthreads();  // the chunk",
                      "    __syncthreads();  // the chunk")], False),
    "f32_unroll1": ([("#pragma unroll 2\n    for (int d = 0; d < DH; d += 4) {",
                      "#pragma unroll 1\n    for (int d = 0; d < DH; d += 4) {")], True),
    "f32_guarded": ([("  if (args.n >= full_tokens<DH>()) {", "  if (false) {")], True),
    "f32_unroll4": ([("#pragma unroll 2\n    for (int d = 0; d < DH; d += 4) {",
                      "#pragma unroll 4\n    for (int d = 0; d < DH; d += 4) {")], True),
    "f32_kv_unroll8": ([("kKvUnroll = FULL ? 16 : 8;", "kKvUnroll = 8;")], True),
    "f32_dq_unroll2": ([("kDqUnroll = FULL ? KC / 4 : 2,", "kDqUnroll = 2,")], True),
    "f32_dq_global": ([
        ("  float dq[QR][QH][4];\n#pragma unroll\n  for (int i = 0; i < QR; ++i)\n#pragma unroll\n"
         "    for (int hh = 0; hh < QH; ++hh)\n#pragma unroll\n"
         "      for (int e = 0; e < 4; ++e) dq[i][hh][e] = 0.f;\n",
         "  float* dqb = a.dq + a.ldq.at(b, h);\n"),
        ("    // ---- B: dQ += dS.K over the chunk's keys, ascending\n",
         "    // ---- B: dQ += dS.K over the chunk's keys, ascending\n"
         "    float dq[QR][QH][4];\n#pragma unroll\n    for (int i = 0; i < QR; ++i)\n"
         "#pragma unroll\n      for (int hh = 0; hh < QH; ++hh) {\n"
         "        const int row = rq + QRG * i;\n"
         "        const float4 v = c > 0 && row < n ? *reinterpret_cast<const float4*>(\n"
         "            dqb + row * a.ldq.row + 4 * (cq + QCG * hh)) : make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "        dq[i][hh][0] = v.x; dq[i][hh][1] = v.y; dq[i][hh][2] = v.z; dq[i][hh][3] = v.w;\n"
         "      }\n"),
        ("    // ---- B: the chunk's dK = dS^T.Q and dV = P^T.dO over every query\n",
         "#pragma unroll\n    for (int i = 0; i < QR; ++i) {\n      const int row = rq + QRG * i;\n"
         "      if (row < n)\n#pragma unroll\n        for (int hh = 0; hh < QH; ++hh)\n"
         "          *reinterpret_cast<float4*>(dqb + row * a.ldq.row + 4 * (cq + QCG * hh)) =\n"
         "              make_float4(dq[i][hh][0], dq[i][hh][1], dq[i][hh][2], dq[i][hh][3]);\n"
         "    }\n"
         "    // ---- B: the chunk's dK = dS^T.Q and dV = P^T.dO over every query\n"),
        ("  float* dqb = a.dq + a.ldq.at(b, h);\n#pragma unroll\n  for (int i = 0; i < QR; ++i) {\n"
         "    const int row = rq + QRG * i;\n    if (row < n)\n#pragma unroll\n"
         "      for (int hh = 0; hh < QH; ++hh)\n"
         "        *reinterpret_cast<float4*>(dqb + row * a.ldq.row + 4 * (cq + QCG * hh)) =\n"
         "            make_float4(dq[i][hh][0], dq[i][hh][1], dq[i][hh][2], dq[i][hh][3]);\n  }\n",
         ""),
    ], True),
}
# K10: (batch, tokens, heads, head dim); K17 likewise, v a view of the
# packed projection's output as the qk_norm block hands it over
SHAPES = (("K10", 64, 256, 16, 64), ("K17", 64, 256, 16, 64), ("K17", 64, 16, 32, 80),
          ("K17", 64, 4, 32, 80), ("K10", 64, 64, 32, 64), ("K10", 64, 16, 32, 80))
# float32: the same shapes, and untimed the edges of the tiled body's key
# chunks (32 keys at dh 64, 16 at dh 80) and of its rule
F32_EDGES = tuple((kind, 3, n, 2, dh) for kind in ("K10", "K17") for dh in (64, 80)
                  for n in (16, 17, 33, 55, 56, 57, 63, 65, 129, 255, 256))
# float32, timed: either side of the rule (f32_first and f32_tiled put one
# body at every token count)
F32_RULE = (("K10", 64, 32, 16, 64), ("K10", 64, 40, 16, 64), ("K10", 64, 48, 16, 64),
            ("K10", 64, 56, 16, 64), ("K10", 64, 64, 16, 64), ("K10", 64, 80, 16, 64))


def entries(dtype=torch.bfloat16):
    """(name, call(lib) -> outputs, timed) per shape; o and lse come from
    the tree's forward. A call launches on the current stream."""
    from tae_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd_lse, fused_qkv_attention_fwd_lse)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    code = build.dtype_code(dtype)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    shapes = SHAPES + (F32_RULE + F32_EDGES if dtype == torch.float32 else ())
    for kind, b, n, h, dh in shapes:
        c = h * dh
        qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda").to(dtype)
        scale = dh ** -0.5
        if kind == "K10":
            do = torch.randn((b, n, c), generator=gen, device="cuda").to(dtype)
            o, lse = fused_qkv_attention_fwd_lse(qkv, h)
            dqkv = torch.empty_like(qkv)

            def call(lib, qkv=qkv, o=o, lse=lse, do=do, dqkv=dqkv, b=b, n=n, h=h, dh=dh,
                     scale=scale):
                build.check(lib.tae_packed_attention_bwd(
                    qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                    dqkv.data_ptr(), b, n, h, dh, scale, code, stream()), "K10")
                return (dqkv,)
            name = f"K10 ({b}, {n}, {3 * c}) h{h} dh{dh}"
        else:
            r = qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
            q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
            do = torch.randn((b, h, n, dh), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_fwd_lse(q, k, v)
            grads = [torch.empty_like(q) for _ in range(3)]
            strides = build.int64_array([st for t in (q, k, v, o, do, *grads)
                                         for st in t.stride()[:3]])

            def call(lib, q=q, k=k, v=v, o=o, lse=lse, do=do, grads=grads, strides=strides,
                     b=b, n=n, h=h, dh=dh, scale=scale):
                build.check(lib.tae_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), *(g.data_ptr() for g in grads), strides, b, n, h, dh,
                    scale, code, stream()), "K17")
                return tuple(grads)
            name = f"K17 ({b}, {h}, {n}, {dh}), v a view of qkv"
        out.append((name + (" fp32" if dtype == torch.float32 else ""), call, b == 64))
    return out


def outputs(call, lib):
    res = call(lib)
    torch.cuda.synchronize()
    return [t.clone() for t in res]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"of {sorted(VARIANTS)} (bf16), {sorted(F32_VARIANTS)} (fp32)")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory to build and time as 'parent'")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    args = ap.parse_args(argv)
    fp32 = args.dtype == "fp32"
    variants, kernels = (F32_VARIANTS, F32_KERNELS) if fp32 else (VARIANTS, (KERNEL,))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    tree = build.library()
    for line in ptxas_report(build.BUILD_ROOT / build.source_hash(), kernels):
        print(f"[tree] {line}")
    names = (["parent"] if args.parent else []) + (
        args.variants or ([] if args.parent else list(variants)))
    cases = entries(torch.float32 if fp32 else torch.bfloat16)
    ok = True
    for name in names:
        if name == "parent":
            path = build.build_library(build.BUILD_ROOT / "parent", args.parent)
            # the fp32 bodies keep the first design's sums: bit-equal
            lib, compared = build.load(path), fp32
        else:
            lib, build_dir = build_variant(name, SOURCE, variants[name][0])
            compared = variants[name][1]
            for line in ptxas_report(build_dir, kernels):
                print(f"[{name}] {line}")
        for label, call, timed in cases:
            want, got = outputs(call, tree), outputs(call, lib)
            if compared:
                same = all(torch.equal(a, b) for a, b in zip(want, got))
                ok &= same
                note = f"; outputs bit-equal: {same}"
            else:
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(want, got))
                note = f"; max |tree - {name}| {diff:.3g}"
            if not timed:
                print(f"[{name}] {label}{note}", flush=True)
                continue
            times = {0: [], 1: []}
            for k, one in ((0, tree), (1, lib), (1, lib), (0, tree)):
                times[k].append(time_ms(lambda one=one: call(one)))
            print(f"[{name}] {label}: tree {statistics.mean(times[0]):.4f} ms "
                  f"({times[0][0]:.4f}, {times[0][1]:.4f}), {name} "
                  f"{statistics.mean(times[1]):.4f} ms ({times[1][0]:.4f}, "
                  f"{times[1][1]:.4f}){note}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
