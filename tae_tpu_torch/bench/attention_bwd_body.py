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

Each variant is built from a copy of the sources under ``tae_tpu_torch/_build/``
and loaded beside the tree's library; the two run in turns (tree, variant,
variant, tree) in one process on one card, each timed by the replay of a
CUDA graph of 20 launches (median of 7). Prints the card's name and power
limit and ptxas's report for the body's instantiations.

    python -m tae_tpu_torch.bench.attention_bwd_body [--parent DIR] [variant ...]

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
# K10: (batch, tokens, heads, head dim); K17 likewise, v a view of the
# packed projection's output as the qk_norm block hands it over
SHAPES = (("K10", 64, 256, 16, 64), ("K17", 64, 256, 16, 64), ("K17", 64, 16, 32, 80),
          ("K17", 64, 4, 32, 80), ("K10", 64, 64, 32, 64), ("K10", 64, 16, 32, 80))


def entries():
    """(name, inputs, call(lib) -> outputs) per shape; o and lse come from
    the tree's forward. A call launches on the current stream."""
    from tae_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd_lse, fused_qkv_attention_fwd_lse)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for kind, b, n, h, dh in SHAPES:
        c = h * dh
        qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda").bfloat16()
        scale = dh ** -0.5
        if kind == "K10":
            do = torch.randn((b, n, c), generator=gen, device="cuda").bfloat16()
            o, lse = fused_qkv_attention_fwd_lse(qkv, h)
            dqkv = torch.empty_like(qkv)

            def call(lib, qkv=qkv, o=o, lse=lse, do=do, dqkv=dqkv, b=b, n=n, h=h, dh=dh,
                     scale=scale):
                build.check(lib.tae_packed_attention_bwd(
                    qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                    dqkv.data_ptr(), b, n, h, dh, scale, 1, stream()), "K10")
                return (dqkv,)
            name = f"K10 ({b}, {n}, {3 * c}) h{h} dh{dh}"
        else:
            r = qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
            q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
            do = torch.randn((b, h, n, dh), generator=gen, device="cuda").bfloat16()
            o, lse = flash_attention_fwd_lse(q, k, v)
            grads = [torch.empty_like(q) for _ in range(3)]
            strides = build.int64_array([st for t in (q, k, v, o, do, *grads)
                                         for st in t.stride()[:3]])

            def call(lib, q=q, k=k, v=v, o=o, lse=lse, do=do, grads=grads, strides=strides,
                     b=b, n=n, h=h, dh=dh, scale=scale):
                build.check(lib.tae_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), *(g.data_ptr() for g in grads), strides, b, n, h, dh,
                    scale, 1, stream()), "K17")
                return tuple(grads)
            name = f"K17 ({b}, {h}, {n}, {dh}), v a view of qkv"
        out.append((name, call))
    return out


def outputs(call, lib):
    res = call(lib)
    torch.cuda.synchronize()
    return [t.clone() for t in res]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory to build and time as 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    tree = build.library()
    for line in ptxas_report(build.BUILD_ROOT / build.source_hash(), KERNEL):
        print(f"[tree] {line}")
    names = (["parent"] if args.parent else []) + (
        args.variants or ([] if args.parent else list(VARIANTS)))
    cases = entries()
    ok = True
    for name in names:
        if name == "parent":
            path = build.build_library(build.BUILD_ROOT / "parent", args.parent)
            lib, compared = build.load(path), False
        else:
            lib, build_dir = build_variant(name, SOURCE, VARIANTS[name][0])
            compared = VARIANTS[name][1]
            for line in ptxas_report(build_dir, KERNEL):
                print(f"[{name}] {line}")
        for label, call in cases:
            want, got = outputs(call, tree), outputs(call, lib)
            if compared:
                same = all(torch.equal(a, b) for a, b in zip(want, got))
                ok &= same
                note = f"; outputs bit-equal: {same}"
            else:
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(want, got))
                note = f"; max |tree - {name}| {diff:.3g}"
            times = {0: [], 1: []}
            for k, one in ((0, tree), (1, lib), (1, lib), (0, tree)):
                times[k].append(time_ms(lambda one=one: call(one)))
            print(f"[{name}] {label}: tree {statistics.mean(times[0]):.4f} ms "
                  f"({times[0][0]:.4f}, {times[0][1]:.4f}), {name} "
                  f"{statistics.mean(times[1]):.4f} ms ({times[1][0]:.4f}, "
                  f"{times[1][1]:.4f}){note}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
