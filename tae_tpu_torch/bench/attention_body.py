"""Time the bf16 attention forward body (K2, K15, K16, and K7 / K8 with its
int8 output; ``csrc/flash_attention.cu``) at the main path's shape, B 64,
N 256, 16 heads of 64, and K8 at the p32 and p64 shapes ((64, 64) tokens,
32 heads of 64; (64, 16), 32 heads of 80), each int8 entry beside K2 alone
(the floor: the same body with a bf16 output) and K2 + the plain
``quantize_rows`` at its shape, as built and in variants made by replacing
a line or two of the sources:

* ``warps4``: 4 warps of 16 query rows a block instead of 8 (``kWarps``);
  ``one_wait``: the first pass waits for all of K and V behind one barrier
  instead of one per 64-key chunk. Their outputs must equal the tree's bit
  for bit: a warp's work does not depend on how many warps share its block
  or on when its operands landed.
* ``stagger``: ``one_wait``, and warp w of a block starts at key tile w
  (modulo the tiles), so that the warps of a block are not all in Q.K^T,
  or all in the softmax, at once; ``stagger_second_pass``: the same only in
  the exact forms' second pass, which waits for nothing. Both sum P.V over
  the tiles in another order: their outputs differ from the tree's by fp32
  rounding and are not compared.
* ``regs255``: one block of 8 warps per SM, registers up to 255 a thread
  (``__launch_bounds__``'s second argument 1 instead of 2).
* ``fast_exp``: ``__expf`` (ex2.approx) for ``expf``, whose few-ulp errors
  the port does not take (the plain versions use the accurate exp); it
  says what the accurate exp costs.
* ``no_softmax``, ``no_staging``, ``no_qk``, ``no_pv``: diagnostics whose
  outputs are wrong and not compared. They take out, in turn, the softmax
  (p = s), the copy of K and V into shared memory, the tensor-core
  instructions of Q.K^T and those of P.V, so that the differences in time
  say what each part costs inside the whole.
* ``one_head``: K7 / K8 with one head a block (``tae::q8::kHeadsPerBlock``,
  2 as built), so clusters of 16 blocks at 16 heads; at 32 heads the
  per-image body no longer takes the shape and K8 runs the flat-row body.
  Not compared, for that; where both run the per-image body (16 heads)
  they are bit-equal, the row max being exact.
* ``no_exchange`` (diagnostic, outputs wrong): each block quantizes with its
  own heads' maxima, a block barrier in place of each cluster barrier, no
  distributed shared memory; ``no_cluster``: the same launched without a
  cluster, so the difference to ``no_exchange`` is what co-scheduling the
  cluster costs.

* ``f32_first``, ``f32_tiled``: the fp32 forward on the first design (a
  warp a query row) or on the register-tiled body at every token count
  (``kF32TiledMinTokens``, 33 as built). Both must equal the tree bit for
  bit: the two bodies add the same products in the same order. They time
  the shape rule. ``f32_pv_unroll8``, ``f32_qk_unroll8``, ``f32_qk_unroll``,
  ``f32_qk_prefetch``, ``f32_lb1``, ``f32_slots3``: the tiled body's P.V
  key loop unrolled by 8 (16 as built), its Q.K^T column loop by 8 or whole
  (4 as built), q loaded a column step ahead, one block an SM with up to
  255 registers a thread, three ring slots (two as built); bit-equal to the
  tree. ``f32_no_qk``, ``f32_no_pv``,
  ``f32_no_products``, ``f32_no_exp``, ``f32_no_sync_k``,
  ``f32_no_sync_v``: diagnostics of the tiled body without its Q.K^T
  products, its P.V products, both, the exp of p, or the barrier of each K
  or each V chunk (outputs not compared).
* the fp32 entries (K2 serving, exact and LSE, K16 and its LSE form at the
  main path's shape; K2 serving and exact at p32's (64, 64) tokens, 32
  heads of 64, p64's and p128's (64, 16) and (64, 4), 32 heads of 80, and
  (64, 32) and (64, 40), 16 heads of 64, either side of the shape rule):
  the forward's CUDA-core form, no TF32.

* ``--parent DIR``: the body of another checkout, built from its kernel
  sources (``DIR`` a ``csrc`` directory, for example of a ``git archive`` of
  the parent commit), its K7 and K8 through their own C entries; its
  outputs must equal the tree's bit for bit where the forward body did not
  change (K2, K15, K16, bf16 and fp32; not K7 / K8, which the parent ran
  on another body).
* ``--cases TEXT``: only the entries whose name holds TEXT (for example
  ``fp32``).

Each variant is built from a copy of the sources under
``tae_tpu_torch/_build/`` and loaded beside the tree's library; the two
run in turns (tree, variant, variant, tree) in one process on one card.
Prints the card's name and power limit, ptxas's report for the body's
instantiations (and the int8-output kernel's, and the fp32 bodies'), K7 /
K8's plan at each shape
with the clusters the card holds at once, and the median device time of
each entry.

    python -m tae_tpu_torch.bench.attention_body [--parent DIR] [--cases TEXT]
        [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import torch

from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.int8 import quantize_rows

REPS, REPLAYS = 20, 7           # launches per CUDA graph, replays (median)
B, N, H, DH, BN = 64, 256, 16, 64, 512
# the int8-output entries' shapes beyond the main path's: (tag, batch,
# tokens, heads, head dim) of p32 and p64
Q8_SHAPES = (("p32", 64, 64, 32, 64), ("p64", 64, 16, 32, 80))
# the fp32 forward's shapes beyond the main path's: (tag, batch, tokens,
# heads, head dim)
F32_SHAPES = (("p32", 64, 64, 32, 64), ("p64", 64, 16, 32, 80), ("p128", 64, 4, 32, 80),
              ("n32", 64, 32, 16, 64), ("n40", 64, 40, 16, 64))
# variant -> ([(text of flash_attention.cu, its replacement) or (file of
# csrc/, text, replacement), ...], outputs compared with the tree's)
ONE_WAIT = ("    if (WAIT && i * KT % kKC == 0) {\n      tae::wait_pending(chunks - 1 - i * KT / kKC);",
            "    if (WAIT && i == 0) {\n      tae::wait_pending(0);")
STAGGER = ("const int c0 = i * KT;", "const int c0 = (i + (threadIdx.x >> 5)) % tiles * KT;")
VARIANTS = {
    "warps4": ([("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")], True),
    "one_wait": ([ONE_WAIT], True),
    "stagger": ([ONE_WAIT, STAGGER], False),
    "stagger_second_pass": ([("const int c0 = i * KT;",
                              "const int c0 = WAIT ? i * KT : (i + (threadIdx.x >> 5)) % tiles * KT;")],
                            False),
    "regs255": ([("__launch_bounds__(kWarps * 32, 16 / kWarps)",
                  "__launch_bounds__(kWarps * 32, 1)")], False),
    "fast_exp": ([("return serving ? expf(fminf(fmaxf(s, kClipLo), kClipHi)) : expf(s - mx);",
                   "return serving ? __expf(fminf(fmaxf(s, kClipLo), kClipHi)) : __expf(s - mx);")],
                 False),
    "no_softmax": ([("float p = softmax_p(s[j][e] * scale, mx[e >> 1], SERVING);",
                     "float p = s[j][e];")], False),
    "no_staging": ([("        stage16(rows, 1, r, ch, kd);\n        stage16(rows, 2, r, ch, vd);\n",
                     "")], False),
    "no_qk": ([("        tae::mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);\n"
                "        tae::mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);\n", "")], False),
    "no_pv": ([("        tae::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);\n"
                "        tae::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);\n", "")], False),
}
F32_RULE = "constexpr int kF32TiledMinTokens = 33;"
QK_PREFETCH = ("""#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD + d);
""", """      float4 qn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qn[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD);
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = qn[i];
          qn[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD + (d + 4) % DH);
        }
""")
VARIANTS.update({
    "f32_first": ([(F32_RULE, "constexpr int kF32TiledMinTokens = kMaxN + 1;")], True),
    "f32_tiled": ([(F32_RULE, "constexpr int kF32TiledMinTokens = 1;")], True),
    # the tiled body's P.V key loop unrolled by 8 (16 as built), its Q.K^T
    # column loop by 8 or whole (4 as built), one block an SM with up to 255
    # registers a thread
    "f32_pv_unroll8": ([("#pragma unroll 16\n      for (int j = 0; j < kc; ++j) {",
                         "#pragma unroll 8\n      for (int j = 0; j < kc; ++j) {")], True),
    "f32_qk_unroll8": ([("#pragma unroll 4\n      for (int d = 0; d < DH; d += 4) {",
                         "#pragma unroll 8\n      for (int d = 0; d < DH; d += 4) {")], True),
    # Q.K^T loading the next four columns of q ahead of the current FMAs
    "f32_qk_prefetch": ([QK_PREFETCH], True),
    "f32_qk_unroll": ([("#pragma unroll 4\n      for (int d = 0; d < DH; d += 4) {",
                        "#pragma unroll\n      for (int d = 0; d < DH; d += 4) {")], True),
    "f32_lb1": ([("__launch_bounds__(kTThreads, 2)", "__launch_bounds__(kTThreads, 1)")], True),
    # the ring at three slots (two as built)
    "f32_slots3": ([("constexpr int kTSlots = 2;", "constexpr int kTSlots = 3;")], True),
    # diagnostics of the tiled body: no Q.K^T products, no P.V products
    "f32_no_qk": ([("      for (int d = 0; d < DH; d += 4) {",
                    "      for (int d = 0; d < DH && n < 0; d += 4) {")], False),
    "f32_no_pv": ([("      for (int j = 0; j < kc; ++j) {",
                    "      for (int j = 0; j < kc && n < 0; ++j) {")], False),
    "f32_no_products": ([("      for (int d = 0; d < DH; d += 4) {",
                          "      for (int d = 0; d < DH && n < 0; d += 4) {"),
                         ("      for (int j = 0; j < kc; ++j) {",
                          "      for (int j = 0; j < kc && n < 0; ++j) {")], False),
    # diagnostics: the barrier of each K chunk, or of each V chunk, dropped
    "f32_no_sync_k": ([("      __syncthreads();  // ... for every thread; slot (c - 1) % S is free",
                        "")], False),
    "f32_no_sync_v": ([("      __syncthreads();  // V chunk c and its p visible to all; chunk c - 1 done with",
                        "")], False),
    "f32_no_exp": ([("key < n ? softmax_p(s[c][r][j], mx, SERVING) : 0.f;",
                     "key < n ? s[c][r][j] - mx : 0.f;")], False),
})
NO_EXCHANGE = [("const float* pm = cluster.map_shared_rank(pmax, r);", "const float* pm = pmax;"),
               ("cluster.sync();  // every rank's partial maxima", "__syncthreads();  //"),
               ("cluster.sync();  // no block's shared memory", "//")]
VARIANTS.update({
    "one_head": ([("attention_q8.cuh", "constexpr int kHeadsPerBlock = 2;",
                   "constexpr int kHeadsPerBlock = 1;")], False),
    "no_exchange": (NO_EXCHANGE, False),
    "no_cluster": (NO_EXCHANGE + [("attr.val.clusterDim.y = p.cluster;",
                                   "attr.val.clusterDim.y = 1;")], False),
})


def build_variant(tag: str, source: str, edits):
    """(library, its build directory) of the kernel sources with ``edits``
    made, built from a copy under ``_build/``: each edit a (text,
    replacement) pair for ``source`` (a file of ``csrc/``) or a (file, text,
    replacement) triple, each text found exactly once."""
    src = build.BUILD_ROOT / f"csrc_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    for edit in edits:
        name, old, new = edit if len(edit) == 3 else (source, *edit)
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} is not in {name} exactly once")
        (src / name).write_text(text.replace(old, new))
    path = build.build_library(build.BUILD_ROOT, src)
    return build.load(path), path.parent


def variant(name: str):
    """(library, its build directory) for the tree (``name`` None) or a
    variant."""
    if name is None:
        return build.library(), build.BUILD_ROOT / build.source_hash()
    return build_variant(name, "flash_attention.cu", VARIANTS[name][0])


def ptxas_report(build_dir, kernels=("attention_fwd_bf16", "attention_q8_bf16",
                                     "attention_fwd_f32_tiled", "attention_fwd_f32")
                 ) -> list[str]:
    """ptxas's registers and spills of the instantiations of ``kernels``."""
    out, entry = [], ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            continue
        kernel = next((k for k in kernels if k in entry), None)
        if kernel is not None and ("spill" in line or "registers" in line):
            m = re.search(kernel + r"ILi(\d+)E(?:Lb(\d))?", entry)
            name = f"{kernel} dh {m.group(1)}"
            if m.group(2) is not None and "bwd" in kernel:
                name += " every row tile live" if m.group(2) == "1" else " guarded"
            elif m.group(2) is not None:
                src = "fp32" if "f32" in kernel else "int8" if "I8Src" in entry else "bf16"
                name += f" {'serving' if m.group(2) == '1' else 'exact'} {src}"
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def time_ms(fn) -> float:
    """Median device ms of one call: REPS calls captured in a CUDA graph,
    the graph replayed REPLAYS times between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    times = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def entries(lib):
    """(name, call, outputs, body) for each C entry on one set of inputs; a
    call launches on the current stream (a graph capture's, while
    capturing). ``body`` is "fwd" for the bf16-output forms of the forward
    body, which a parent's must equal bit for bit, and "q8" for K7 / K8 and
    K2 + quantize_rows. The inputs stay referenced by the calls: a closure
    that held only their addresses would let the allocator hand the memory
    to the next set of inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = H * DH
    qkv = torch.randn((B, N, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    r = qkv.view(B, N, 3, H, DH).permute(2, 0, 3, 1, 4)
    q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
    qkv_q = torch.randint(-127, 128, (B, N, 3 * c), generator=gen, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand((3 * c // BN, B * N, 1), generator=gen, device="cuda") * 0.02 + 0.001
    out = torch.empty((B, N, c), dtype=torch.bfloat16, device="cuda")
    o4 = torch.empty((B, H, N, DH), dtype=torch.bfloat16, device="cuda")
    lse = torch.empty((B, H, N), dtype=torch.float32, device="cuda")
    strides = build.int64_array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 *o4.stride()[:3]])
    scale = DH ** -0.5

    def run(rc):
        build.check(rc, "attention forward")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    runs = [
        ("K2 serving", lambda: run(lib.tae_packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, H, DH, scale, 1, 1, stream())), (out,),
         "fwd"),
        ("K2 exact", lambda: run(lib.tae_packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, H, DH, scale, 0, 1, stream())), (out,),
         "fwd"),
        ("K2 LSE", lambda: run(lib.tae_packed_attention_fwd_lse(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, N, H, DH, scale, 1,
            stream())), (out, lse), "fwd"),
        ("K16", lambda: run(lib.tae_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), None, strides, B, N,
            H, DH, scale, 1, stream())), (o4,), "fwd"),
        ("K16 LSE", lambda: run(lib.tae_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), lse.data_ptr(),
            strides, B, N, H, DH, scale, 1, stream())), (o4, lse), "fwd"),
        ("K15", lambda: run(lib.tae_qkv_i8_attention_fwd(
            qkv_q.data_ptr(), scales.data_ptr(), out.data_ptr(), B, N, H, DH, BN, scale,
            stream())), (out,), "fwd"),
    ]
    for tag, b, n, h, dh in (("p16", B, N, H, DH), *Q8_SHAPES):
        runs += q8_entries(lib, gen, tag, b, n, h, dh, run, stream)
    return runs + f32_entries(lib, gen, run, stream)


def f32_entries(lib, gen, run, stream):
    """The fp32 forward: K2's three forms and K16's two at the main path's
    shape (v a strided view of the packed qkv), K2 serving and exact at
    F32_SHAPES."""
    c = H * DH
    qkv = torch.randn((B, N, 3 * c), generator=gen, device="cuda")
    r = qkv.view(B, N, 3, H, DH).permute(2, 0, 3, 1, 4)
    q, k, v = r[0].contiguous(), r[1].contiguous(), r[2]
    out = torch.empty((B, N, c), device="cuda")
    o4 = torch.empty((B, H, N, DH), device="cuda")
    lse = torch.empty((B, H, N), device="cuda")
    strides = build.int64_array([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 *o4.stride()[:3]])
    scale = DH ** -0.5
    runs = [
        ("K2 serving fp32", lambda: run(lib.tae_packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, H, DH, scale, 1, 0, stream())), (out,),
         "fwd"),
        ("K2 exact fp32", lambda: run(lib.tae_packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, H, DH, scale, 0, 0, stream())), (out,),
         "fwd"),
        ("K2 LSE fp32", lambda: run(lib.tae_packed_attention_fwd_lse(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, N, H, DH, scale, 0,
            stream())), (out, lse), "fwd"),
        ("K16 fp32", lambda: run(lib.tae_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), None, strides, B, N,
            H, DH, scale, 0, stream())), (o4,), "fwd"),
        ("K16 LSE fp32", lambda: run(lib.tae_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), lse.data_ptr(),
            strides, B, N, H, DH, scale, 0, stream())), (o4, lse), "fwd"),
    ]
    for tag, b, n, h, dh in F32_SHAPES:
        x = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda")
        y = torch.empty((b, n, h * dh), device="cuda")
        for serving in (1, 0):
            runs.append((f"K2 {'serving' if serving else 'exact'} fp32 {tag} "
                         f"({b}, {n}, {3 * h * dh}) h{h} dh{dh}",
                         lambda x=x, y=y, b=b, n=n, h=h, dh=dh, serving=serving: run(
                             lib.tae_packed_attention_fwd(x.data_ptr(), y.data_ptr(), b, n, h,
                                                          dh, dh ** -0.5, serving, 0,
                                                          stream())), (y,), "fwd"))
    return runs


def q8_entries(lib, gen, tag, b, n, h, dh, run, stream):
    """K7 (over 64 tokens) or K8 at one shape, with K2 (serving) alone and
    K2 + the plain quantize_rows at the same shape."""
    c = h * dh
    x = torch.randn((b, n, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.empty((b, n, c), dtype=torch.bfloat16, device="cuda")
    yq = torch.empty((b, n, c), dtype=torch.int8, device="cuda")
    ys = torch.empty((b, n, 1), dtype=torch.float32, device="cuda")
    name, entry = (("K7", lib.tae_packed_attention_q8_fwd) if n > 64
                   else ("K8", lib.tae_wide_attention_q8_fwd))
    scale = dh ** -0.5
    shape = f"({b}, {n}, {3 * c}) h{h} dh{dh}"

    def k2():
        run(lib.tae_packed_attention_fwd(x.data_ptr(), y.data_ptr(), b, n, h, dh, scale, 1,
                                         1, stream()))

    def k2_quantize():
        k2()
        return quantize_rows(y)

    held = {}

    def k2_quantize_held():
        held["out"] = k2_quantize()

    return [
        (f"{name} {tag} {shape}", lambda: run(entry(
            x.data_ptr(), yq.data_ptr(), ys.data_ptr(), b, n, h, dh, scale, 1, stream())),
         (yq, ys), "q8"),
        (f"K2 serving {tag}", k2, (y,), "fwd"),
        (f"K2 + quantize_rows {tag}", k2_quantize_held, (y,), "q8"),
    ]


def print_plans(tag: str, lib) -> None:
    """K7 / K8's plan at each shape in ``lib`` (absent from a parent's
    library) and the clusters of that shape the card holds at once."""
    if not hasattr(lib, "tae_attention_q8_plan"):
        return
    import ctypes

    for _, _, n, h, dh in (("p16", B, N, H, DH), *Q8_SHAPES):
        out = (ctypes.c_int * 6)()
        build.check(lib.tae_attention_q8_plan(n, h, dh, out), "tae_attention_q8_plan")
        plan = ("flat-row body" if not out[0] else
                f"cluster {out[1]}, {out[2]} heads a block, {out[3]} warps, {out[4]} bytes; "
                f"{out[5]} clusters at once")
        print(f"[{tag}] plan n {n} h {h} dh {dh}: {plan}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    parent = cases = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent, argv = pathlib.Path(argv[i + 1]), argv[:i] + argv[i + 2:]
    if "--cases" in argv:
        i = argv.index("--cases")
        cases, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    names = (["parent"] if parent else []) + (argv or ([] if parent else list(VARIANTS)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    tree, build_dir = variant(None)
    for line in ptxas_report(build_dir):
        print(f"[tree] {line}")
    print_plans("tree", tree)
    base = entries(tree)
    ok = True
    for name in names:
        if name == "parent":
            lib = build.load(build.build_library(build.BUILD_ROOT / "parent", parent))
            compared = {"fwd"}
        else:
            lib, build_dir = variant(name)
            compared = {"fwd", "q8"} if VARIANTS[name][1] else set()
            for line in ptxas_report(build_dir):
                print(f"[{name}] {line}")
            print_plans(name, lib)
        runs = entries(lib)
        for (entry, call0, res0, body), (_, call1, res1, _) in zip(base, runs):
            if cases is not None and cases not in entry:
                continue
            same = None
            if body in compared:
                outs = []
                for call, res in ((call0, res0), (call1, res1)):
                    call()
                    torch.cuda.synchronize()
                    outs.append([t.clone() for t in res])
                same = all(torch.equal(a, b) for a, b in zip(*outs))
                ok &= same
                if not same:
                    worst = max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(*outs))
                    print(f"[{name}] {entry}: max |tree - {name}| {worst:.3g}")
            times = {0: [], 1: []}
            for k, call in ((0, call0), (1, call1), (1, call1), (0, call0)):
                times[k].append(time_ms(call))
            print(f"[{name}] {entry}: tree {statistics.mean(times[0]):.4f} ms "
                  f"({times[0][0]:.4f}, {times[0][1]:.4f}), {name} "
                  f"{statistics.mean(times[1]):.4f} ms ({times[1][0]:.4f}, {times[1][1]:.4f})"
                  + ("" if same is None else f"; outputs bit-equal: {same}"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
