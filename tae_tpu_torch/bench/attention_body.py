"""Time the bf16 attention forward body (K2, K15, K16;
``csrc/flash_attention.cu``) at the main path's shape, B 64, N 256, 16
heads of 64, as built and in variants made by replacing a line or two of
the source:

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

* ``--parent DIR``: the body of another checkout, built from its kernel
  sources (``DIR`` a ``csrc`` directory, for example of a ``git archive`` of
  the parent commit); its outputs must equal the tree's bit for bit where
  the forward body did not change.

Each variant is built from a copy of the sources under
``tae_tpu_torch/_build/`` and loaded beside the tree's library; the two
run in turns (tree, variant, variant, tree) in one process on one card.
Prints the card's name and power limit, ptxas's report for the body's
instantiations, and the median device time of each entry.

    python -m tae_tpu_torch.bench.attention_body [--parent DIR] [variant ...]

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

REPS, REPLAYS = 20, 7           # launches per CUDA graph, replays (median)
B, N, H, DH, BN = 64, 256, 16, 64, 512
# variant -> ([(text of flash_attention.cu, its replacement), ...], outputs
# compared with the tree's)
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


def build_variant(tag: str, source: str, edits):
    """(library, its build directory) of the kernel sources with ``edits``
    ((text, replacement) pairs, each text found exactly once) made to
    ``source`` (a file of ``csrc/``), built from a copy under ``_build/``."""
    text = (build.CSRC_DIR / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} is not in {source} exactly once")
        text = text.replace(old, new)
    src = build.BUILD_ROOT / f"csrc_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    (src / source).write_text(text)
    path = build.build_library(build.BUILD_ROOT, src)
    return build.load(path), path.parent


def variant(name: str):
    """(library, its build directory) for the tree (``name`` None) or a
    variant."""
    if name is None:
        return build.library(), build.BUILD_ROOT / build.source_hash()
    return build_variant(name, "flash_attention.cu", VARIANTS[name][0])


def ptxas_report(build_dir, kernel: str = "attention_fwd_bf16") -> list[str]:
    """ptxas's registers and spills of ``kernel``'s instantiations."""
    out, entry = [], ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif kernel in entry and ("spill" in line or "registers" in line):
            m = re.search(kernel + r"ILi(\d+)E(?:Lb(\d))?", entry)
            name = f"dh {m.group(1)}"
            if m.group(2) is not None:
                name += (f" {'serving' if m.group(2) == '1' else 'exact'}"
                         f" {'int8' if 'I8Src' in entry else 'bf16'}")
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
    """(name, call, outputs) for each C entry on one set of inputs; a call
    launches on the current stream (a graph capture's, while capturing)."""
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

    return [
        ("K2 serving", lambda: run(lib.tae_packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, H, DH, scale, 1, 1, stream())), (out,)),
        ("K2 exact", lambda: run(lib.tae_packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, N, H, DH, scale, 0, 1, stream())), (out,)),
        ("K2 LSE", lambda: run(lib.tae_packed_attention_fwd_lse(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, N, H, DH, scale, 1,
            stream())), (out, lse)),
        ("K16", lambda: run(lib.tae_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), None, strides, B, N,
            H, DH, scale, 1, stream())), (o4,)),
        ("K16 LSE", lambda: run(lib.tae_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), lse.data_ptr(),
            strides, B, N, H, DH, scale, 1, stream())), (o4, lse)),
        ("K15", lambda: run(lib.tae_qkv_i8_attention_fwd(
            qkv_q.data_ptr(), scales.data_ptr(), out.data_ptr(), B, N, H, DH, BN, scale,
            stream())), (out,)),
    ]


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
    tree, build_dir = variant(None)
    for line in ptxas_report(build_dir):
        print(f"[tree] {line}")
    base = entries(tree)
    ok = True
    for name in names:
        if name == "parent":
            lib = build.load(build.build_library(build.BUILD_ROOT / "parent", parent))
            compared = True
        else:
            lib, build_dir = variant(name)
            compared = VARIANTS[name][1]
        if name == "warps4":
            for line in ptxas_report(build_dir):
                print(f"[{name}] {line}")
        runs = entries(lib)
        for (entry, call0, res0), (_, call1, res1) in zip(base, runs):
            if compared:
                outs = []
                for call, res in ((call0, res0), (call1, res1)):
                    call()
                    torch.cuda.synchronize()
                    outs.append([t.clone() for t in res])
                same = all(torch.equal(a, b) for a, b in zip(*outs))
                ok &= same
            times = {0: [], 1: []}
            for k, call in ((0, call0), (1, call1), (1, call1), (0, call0)):
                times[k].append(time_ms(call))
            print(f"[{name}] {entry} (B {B}, N {N}, H {H}, dh {DH}): tree "
                  f"{statistics.mean(times[0]):.4f} ms ({times[0][0]:.4f}, "
                  f"{times[0][1]:.4f}), {name} {statistics.mean(times[1]):.4f} ms "
                  f"({times[1][0]:.4f}, {times[1][1]:.4f})"
                  + (f"; outputs bit-equal: {same}" if compared else ""))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
