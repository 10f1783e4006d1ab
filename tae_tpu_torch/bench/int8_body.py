"""Time the int8 GEMM body behind K4 (``csrc/int8_matmul.cu``, every form)
and K5 (``csrc/int8_block.cu``) at the shapes of the paths that run them,
as built and in variants made by replacing text of the sources:

* tile shapes and ring depths (``k4_large_*``, ``k4_medium_*``,
  ``k4_small_*``, ``fc1_*``, ``fc2_*``), and ``no_split`` (K4's row
  epilogues with their K split turned off): their outputs must equal the
  tree's bit for bit (int32 sums are exact in any order; K5's fp32 fold
  follows the hidden blocks, not the tiles);
* diagnostics whose outputs are wrong and not compared: ``no_mma`` (no
  tensor-core instruction), ``no_ldmatrix`` (fragments not read from shared
  memory), ``no_staging`` (no cp.async into the ring), ``no_epilogue`` (the
  product's results dropped), ``no_finish`` (K4's finish pass and K5's not
  launched), ``fc1_only`` / ``fc2_only`` (K5's other launches left out).
  The differences in time say what each part costs inside the whole.
* ``--parent DIR``: the kernels of another checkout (``DIR`` a ``csrc``
  directory, for example of a ``git archive`` of the parent commit) through
  its own C entries, timed against the tree in turns; K4's outputs must be
  bit-equal, and K5's where the parent ran one hidden group (elsewhere the
  fp32 sums of its groups are added in another order, and only a tolerance
  holds).

Each variant is built from a copy of the sources under ``tae_tpu_torch/_build/``
and loaded beside the tree's library; the two run in turns (tree, other,
other, tree) in one process on one card, each timed by the replay of a CUDA
graph of 20 launches (median of 7). Prints the card's name and power limit,
ptxas's report of the int8 kernels, each time beside its bound and, for K4,
``torch._int_mm`` (the product alone) at the shape.

    python -m tae_tpu_torch.bench.int8_body [--parent DIR] [--out FILE] [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

import torch

from tae_tpu_torch.bench.attention_body import time_ms
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.int8_block import mlp_hidden_groups, mlp_tiles
from tae_tpu_torch.ops.cuda.int8_matmul import ln_chain_rows, matmul_tiles

HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12   # H100 SXM data sheet
KERNELS = ("int8_matmul", "int8_mlp", "quantize_x")
BH = 256
# K4: (label, m, k, n, bias, residual, form) with form plain / ln / q8 / qik
K4_CASES = [("p16 qkv", 16384, 1024, 3072, True, False, "plain"),
            ("p16 proj +ln_out", 16384, 1024, 1024, True, True, "ln"),
            ("p16 qkv q8_out", 16384, 1024, 3072, True, False, "q8"),
            ("p16 dict_proj", 16384, 1024, 256, False, False, "plain"),
            ("p16 embed", 16384, 256, 1024, True, False, "plain"),
            ("p16 pred", 16384, 1024, 768, True, False, "plain"),
            ("p16 in-kernel quantize", 16384, 1024, 1024, True, True, "qik"),
            ("p32 qkv", 4096, 2048, 6144, True, False, "plain"),
            ("p32 proj +ln_out", 4096, 2048, 2048, True, True, "ln")]
for _m in (256, 32, 4):
    K4_CASES += [(f"p128 qkv M={_m}", _m, 2560, 7680, True, False, "plain"),
                 (f"p128 proj +ln_out M={_m}", _m, 2560, 2560, True, True, "ln")]
# K5: (label, m, d, hidden), block_h 256, ln_next
K5_CASES = [("p16", 16384, 1024, 4096), ("p32", 4096, 2048, 8192)] + [
    (f"p128 M={m}", m, 2560, 10240) for m in (256, 32, 4)]

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries of the earlier kernels (the --parent checkout), which took
# row-block sizes
PARENT_SIGNATURES = {
    "tae_int8_matmul_fwd": ((_VP,) * 7 + (_I,) * 6 + (_VP, _VP, _I, _F, _VP, _VP, _VP), _I),
    "tae_int8_matmul_rows_fwd": ((_VP, _I, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP, _I, _I,
                                  _I, _I, _VP), _I),
    "tae_int8_mlp_fwd": ((_VP,) * 10 + (_I,) * 7 + (_VP, _VP, _I, _F, _VP, _VP, _VP, _I, _VP),
                         _I),
}

MM, BLK, COMMON = "int8_matmul.cu", "int8_block.cu", "int8_common.cuh"
LARGE = "using kLarge = Tiles<128, 128, 2, 4, 3, 2>;"
FC1 = "using kFc1Bh256 = Tiles<64, 256, 2, 4, 2, 2>;"
FC2 = "using kFc2Large = Tiles<64, 128, 2, 4, 3, 2>;"
MMA_LINE = ("        for (int ni = 0; ni < S::NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], "
            "bf[ni][1]);")
# variant -> ([(file of csrc/, its text, the replacement), ...], outputs
# compared with the tree's, {rule overrides})
VARIANTS = {
    "k4_large_4x2": ([(MM, LARGE, "using kLarge = Tiles<128, 128, 4, 2, 3, 2>;")], True, {}),
    "k4_large_4warps": ([(MM, LARGE, "using kLarge = Tiles<128, 128, 2, 2, 3>;")], True, {}),
    "k4_large_128x256": ([(MM, LARGE, "using kLarge = Tiles<128, 256, 2, 4, 3>;")], True, {}),
    "k4_large_256x128_16w": ([(MM, LARGE, "using kLarge = Tiles<256, 128, 4, 4, 3>;")], True,
                             {}),
    "k4_medium_4warps": ([(MM, "using kMedium = Tiles<64, 128, 2, 4, 4, 2>;",
                           "using kMedium = Tiles<64, 128, 2, 2, 4>;")], True, {}),
    "k4_small_16x32": ([(MM, "using kSmall = Tiles<16, 64, 1, 2, 4>;",
                         "using kSmall = Tiles<16, 32, 1, 1, 4>;")], True, {}),
    "no_split": ([], True, {"splits": 1}),
    "fc1_128x256": ([(BLK, FC1, "using kFc1Bh256 = Tiles<128, 256, 2, 4, 3>;")], True, {}),
    "fc1_64x256_4warps": ([(BLK, FC1, "using kFc1Bh256 = Tiles<64, 256, 1, 4, 3>;")], True, {}),
    "fc1_16w": ([(BLK, FC1, "using kFc1Bh256 = Tiles<128, 256, 4, 4, 3>;")], True, {}),
    "fc1_64x256_1x8": ([(BLK, FC1, "using kFc1Bh256 = Tiles<64, 256, 1, 8, 2, 2>;")], True, {}),
    "fc1_128x256_16w_2s": ([(BLK, FC1, "using kFc1Bh256 = Tiles<128, 256, 2, 8, 2>;")], True,
                           {}),
    "fc1_64x256_2x4": ([(BLK, FC1, "using kFc1Bh256 = Tiles<64, 256, 2, 4, 2, 2>;")], True, {}),
    "fc2_128x128": ([(BLK, FC2, "using kFc2Large = Tiles<128, 128, 2, 4, 3>;")], True, {}),
    "fc2_128x128_16w": ([(BLK, FC2, "using kFc2Large = Tiles<128, 128, 4, 4, 3>;")], True, {}),
    "fc2_mid_2blocks": ([(BLK, "using kFc2Mid = Tiles<64, 64, 2, 2, 4>;",
                          "using kFc2Mid = Tiles<64, 64, 2, 2, 4, 2>;")], True, {}),
    "no_mma": ([(COMMON, MMA_LINE, MMA_LINE.split(" mma_s8")[0] + " {}")], False, {}),
    "no_ldmatrix": ([(COMMON, "        ldmatrix_x4_at(af[mi], slot + a_off + mi * 16 * kLd + "
                              "kk * 32);",
                      "        af[mi][0] = af[mi][1] = af[mi][2] = af[mi][3] = slot + kk;"),
                     (COMMON, "        ldmatrix_x4_at(r, slot + b_off + nj * 16 * kLd + kk * 32);",
                      "        r[0] = r[1] = r[2] = r[3] = slot + nj;")], False, {}),
    "no_staging": ([(COMMON, "    cp_async16_zfill(d + i * kStep * kLd, valid ? s + i * kStep * ld : src, "
                              "valid);\n", "")], False, {}),
    "no_epilogue": ([(MM, "    if (row >= p.m || col >= p.n) return;",
                      "    if (row >= 0) return;"),
                     (BLK, "  transpose_rows8<S>(acc);\n", "  return;\n"),
                     (BLK, "    if (row >= p.m || col >= p.d) return;",
                      "    if (row >= 0) return;")], False, {}),
    "no_finish": ([(MM, "  int8_matmul_finish_kernel<<<static_cast<unsigned>(p.m), "
                        "kFinishThreads, smem, stream>>>(p,", "  if (false) int8_matmul_finish_kernel"
                        "<<<static_cast<unsigned>(p.m), kFinishThreads, smem, stream>>>(p,"),
                   (BLK, "  int8_mlp_finish_kernel<<<static_cast<unsigned>(p.m), kFinishThreads, "
                         "smem, stream>>>(p);", "")], False, {}),
    "fc1_only": ([(BLK, "  switch (fc2_tiles) {", "  return 0;\n  switch (fc2_tiles) {")],
                 False, {}),
    "fc2_only": ([(BLK, "  switch (fc1_tiles) {", "  switch (fc1_tiles + 100) {"),
                  (BLK, "  if (rc != 0) return rc;\n  switch (fc2_tiles) {",
                   "  rc = 0;\n  switch (fc2_tiles) {"),
                  (BLK, "  int8_mlp_finish_kernel<<<static_cast<unsigned>(p.m), kFinishThreads, "
                        "smem, stream>>>(p);", "")], False, {}),
}


def build_variant(tag: str, edits) -> tuple[ctypes.CDLL, pathlib.Path]:
    """(library, build directory) of the tree's kernel sources with
    ``edits`` ((file, text, replacement), each text found exactly once)."""
    src = build.BUILD_ROOT / f"csrc_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    for name, old, new in edits:
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} is not in {name} exactly once")
        (src / name).write_text(text.replace(old, new))
    path = build.build_library(build.BUILD_ROOT, src)
    return build.load(path), path.parent


def load_parent(csrc: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_library(build.BUILD_ROOT / "parent", csrc)))
    for name, (argtypes, restype) in PARENT_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    lib.tae_error_string.argtypes, lib.tae_error_string.restype = (_I,), ctypes.c_char_p
    return lib


def ptxas_report(build_dir: pathlib.Path) -> list[str]:
    """ptxas's registers and spills of the int8 kernels' instantiations."""
    out, entry = [], ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif any(k in entry for k in KERNELS) and ("spill" in line or "registers" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def parent_mlp_rows(d: int, block_h: int) -> int:
    """The parent's rows per K5 block (its mlp_block_rows): 32 rows with
    256-column tiles if they fit a block's shared memory, else 16."""
    for rows, cols in ((32, 256), (16, 128)):
        fixed = rows * ((d + 4) * 4 + block_h + 16 + 4)
        hidden = rows * (-(-block_h // cols) * cols + 4) * 4
        ring = 3 * (rows + cols) * 80
        work = max(ring, hidden) if block_h <= cols else ring + hidden
        if fixed + work <= 232448:
            return rows
    raise ValueError("no parent block size")


def check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: cudaError {rc} ({lib.tae_error_string(rc).decode()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k4_case(gen, label, m, k, n, bias, residual, form, sms):
    """(label, {side: call(lib, rule) -> outputs}, bound ms, _int_mm call,
    compare exactly)."""
    bf16 = torch.bfloat16

    def ri8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    x = ri8((m, k))
    sx = rand((m, 1), 0.01, 0.06)
    if form == "qik":
        x = (torch.randn((m, k), generator=gen, device="cuda") * 3).to(bf16)
        sx = (x.float().abs().amax(dim=1, keepdim=True) / 127).clamp_min(1e-12)
    w, sw = ri8((n, k)), rand((n,), 1e-4, 5e-4)
    b = torch.randn(n, generator=gen, device="cuda").to(bf16) if bias else None
    r = torch.randn((m, n), generator=gen, device="cuda").to(bf16) if residual else None
    g = (torch.randn(n, generator=gen, device="cuda") * 0.5 + 1).to(bf16)
    be = (torch.randn(n, generator=gen, device="cuda") * 0.2).to(bf16)
    bn = 512 if n % 512 == 0 else n
    q8 = form == "q8"
    out = torch.empty((m, n), dtype=torch.int8 if q8 else bf16, device="cuda")
    nq = torch.empty((m, n), dtype=torch.int8, device="cuda")
    ns = torch.empty((m, 1), dtype=torch.float32, device="cuda")
    so = torch.empty((n // bn, m, 1), dtype=torch.float32, device="cuda")
    ws = torch.empty((8, m, n), dtype=torch.int32, device="cuda")
    xq_ws = torch.empty((m, k), dtype=torch.int8, device="cuda")
    p = build.ptr
    bcode = 1 if bias else 0
    outs = {"plain": (out,), "ln": (out, nq, ns), "q8": (out, so), "qik": (out,)}[form]

    def tree(lib, rule):
        tiles, splits = matmul_tiles(m, n, k, sms, form in ("ln", "q8"))
        splits = rule.get("splits", splits)
        if form in ("plain", "ln"):
            ln = form == "ln"
            check(lib, lib.tae_int8_matmul_fwd(
                x.data_ptr(), sx.data_ptr(), w.data_ptr(), sw.data_ptr(), p(b), p(r),
                out.data_ptr(), m, n, k, 1, bcode, int(ln), g.data_ptr(), be.data_ptr(), 1,
                1e-6, nq.data_ptr(), ns.data_ptr(), tiles, splits, ws.data_ptr(), stream()),
                label)
        else:
            check(lib, lib.tae_int8_matmul_rows_fwd(
                x.data_ptr(), 1 if form == "qik" else 2, sx.data_ptr(), w.data_ptr(),
                sw.data_ptr(), p(b), bcode, p(r), out.data_ptr(), 1,
                so.data_ptr() if q8 else None, bn if q8 else 0, m, n, k, tiles, splits,
                ws.data_ptr(), xq_ws.data_ptr(), stream()), label)
        return outs

    def parent(lib, rule):
        if form in ("plain", "ln"):
            ln_rows = ln_chain_rows(n) if form == "ln" else 0
            check(lib, lib.tae_int8_matmul_fwd(
                x.data_ptr(), sx.data_ptr(), w.data_ptr(), sw.data_ptr(), p(b), p(r),
                out.data_ptr(), m, n, k, 1, bcode, ln_rows, g.data_ptr(), be.data_ptr(), 1,
                1e-6, nq.data_ptr(), ns.data_ptr(), stream()), label)
        else:
            check(lib, lib.tae_int8_matmul_rows_fwd(
                x.data_ptr(), 1 if form == "qik" else 2, sx.data_ptr(), w.data_ptr(),
                sw.data_ptr(), p(b), bcode, p(r), out.data_ptr(), 1,
                so.data_ptr() if q8 else None, bn if q8 else 0, m, n, k, stream()), label)
        return outs

    nbytes = sum(t.numel() * t.element_size() for t in (x, sx, w, sw, b, r, *outs)
                 if t is not None) + (g.numel() * 4 if form == "ln" else 0)
    bnd = max(nbytes / HBM_BYTES_PER_S, 2.0 * m * k * n / INT8_OPS_PER_S) * 1e3
    xi = x if x.dtype == torch.int8 else ri8((m, k))
    lib_mm = None if m < 17 else (lambda: torch._int_mm(xi, w.t()))
    return f"K4 {label} ({m}, {k}) x ({n}, {k})", {"tree": tree, "parent": parent}, bnd, \
        lib_mm, True


def k5_case(gen, label, m, d, hdim, sms):
    bf16 = torch.bfloat16

    def ri8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    xq, sx = ri8((m, d)), rand((m, 1), 0.005, 0.025)
    w1, s1 = ri8((hdim, d)), rand((hdim,), 1e-4, 5e-4)
    w2, s2 = ri8((d, hdim)), rand((d,), 1e-4, 5e-4)
    b1 = (torch.randn(hdim, generator=gen, device="cuda") * 0.1).to(bf16)
    b2 = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(bf16)
    r = torch.randn((m, d), generator=gen, device="cuda").to(bf16)
    g = (torch.randn(d, generator=gen, device="cuda") * 0.5 + 1).to(bf16)
    be = (torch.randn(d, generator=gen, device="cuda") * 0.2).to(bf16)
    out = torch.empty((m, d), dtype=bf16, device="cuda")
    nq = torch.empty((m, d), dtype=torch.int8, device="cuda")
    ns = torch.empty((m, 1), dtype=torch.float32, device="cuda")
    hq = torch.empty((m, hdim), dtype=torch.int8, device="cuda")
    sh = torch.empty((hdim // BH, m), dtype=torch.float32, device="cuda")
    part = torch.empty((64, m, d), dtype=torch.float32, device="cuda")
    inputs = (xq, sx, w1, s1, b1, w2, s2, b2, r, out)
    outs = (out, nq, ns)

    def common():
        return (*(t.data_ptr() for t in inputs), m, d, hdim, BH)

    def tree(lib, rule):
        fc1, fc2, groups = mlp_tiles(m, d, hdim, BH, sms)
        check(lib, lib.tae_int8_mlp_fwd(
            *common(), 1, 1, g.data_ptr(), be.data_ptr(), 1, 1e-6, nq.data_ptr(),
            ns.data_ptr(), hq.data_ptr(), sh.data_ptr(), part.data_ptr(), groups, fc1, fc2,
            stream()), label)
        return outs

    rows = parent_mlp_rows(d, BH)
    pgroups = mlp_hidden_groups(-(-m // rows), hdim // BH, sms)

    def parent(lib, rule):
        check(lib, lib.tae_int8_mlp_fwd(
            *common(), rows, 1, 1, g.data_ptr(), be.data_ptr(), 1, 1e-6, nq.data_ptr(),
            ns.data_ptr(), part.data_ptr() if pgroups > 1 else None, pgroups, stream()), label)
        return outs

    nbytes = sum(t.numel() * t.element_size() for t in (xq, sx, w1, s1, b1, w2, s2, b2, r,
                                                          g, be, *outs))
    bnd = max(nbytes / HBM_BYTES_PER_S, 4.0 * m * d * hdim / INT8_OPS_PER_S) * 1e3
    exact = mlp_tiles(m, d, hdim, BH, sms)[2] == 1 and pgroups == 1
    return (f"K5 {label} ({m}, {d}) hidden {hdim}, parent groups {pgroups}",
            {"tree": tree, "parent": parent}, bnd, None, exact)


def outputs(call, lib, rule):
    res = call(lib, rule)
    torch.cuda.synchronize()
    return [t.clone() for t in res]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory to build and time as 'parent'")
    ap.add_argument("--out", type=pathlib.Path, default=None, help="JSON lines of the results")
    ap.add_argument("--cases", default="", help="only cases whose label holds this text")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    tree = build.library()
    for line in ptxas_report(build.BUILD_ROOT / build.source_hash()):
        print(f"[tree] {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [k4_case(gen, *c, sms) for c in K4_CASES] + [k5_case(gen, *c, sms)
                                                           for c in K5_CASES]
    cases = [c for c in cases if args.cases in c[0]]
    names = (["parent"] if args.parent else []) + (
        args.variants or ([] if args.parent else list(VARIANTS)))
    sink = args.out.open("a") if args.out else None
    ok = True
    for name in names:
        rule = {}
        if name == "parent":
            lib, side, compared = load_parent(args.parent), "parent", True
        else:
            edits, compared, rule = VARIANTS[name]
            lib, build_dir = build_variant(name, edits) if edits else (tree, None)
            side = "tree"
            if build_dir is not None and not name.startswith("no_"):
                for line in ptxas_report(build_dir):
                    print(f"[{name}] {line}")
        for label, calls, bnd, lib_mm, exact in cases:
            want, got = outputs(calls["tree"], tree, {}), outputs(calls[side], lib, rule)
            note = ""
            if compared:
                same = all(torch.equal(a, b) for a, b in zip(want, got))
                if exact:
                    ok &= same
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(want, got))
                note = f"; bit-equal {same}" + ("" if exact else f" (max |diff| {diff:.3g})")
            times = {0: [], 1: []}
            for kk, (one, call, rl) in ((0, (tree, calls["tree"], {})),
                                        (1, (lib, calls[side], rule)),
                                        (1, (lib, calls[side], rule)),
                                        (0, (tree, calls["tree"], {}))):
                times[kk].append(time_ms(lambda one=one, call=call, rl=rl: call(one, rl)))
            mm = time_ms(lib_mm) if lib_mm is not None and name == names[0] else None
            t0, t1 = statistics.mean(times[0]), statistics.mean(times[1])
            print(f"[{name}] {label}: tree {t0:.4f} ms ({times[0][0]:.4f}, {times[0][1]:.4f}), "
                  f"{name} {t1:.4f} ms ({times[1][0]:.4f}, {times[1][1]:.4f}); bound "
                  f"{bnd:.4f}" + ("" if mm is None else f"; _int_mm {mm:.4f}") + note,
                  flush=True)
            if sink:
                sink.write(json.dumps(dict(card=card, variant=name, case=label, tree_ms=times[0],
                                           other_ms=times[1], bound_ms=bnd, int_mm_ms=mm,
                                           note=note)) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
