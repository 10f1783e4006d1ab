"""Time the w4a8 products K12 (``csrc/int4_matmul.cu``) and K13
(``csrc/int4_block.cu``), which run the int8 GEMM body (``int8_common.cuh``'s
``gemm_mainloop``) with a packed int4 B operand, at the shapes of the int4
paths (p128 at 256 / 32 / 4 rows, p16 at 16384), beside K4 and K5 on int8
weights of the same shapes, as built and in variants made by replacing text
of the sources:

* tile shapes and ring depths (``k12_*``, ``fc1_*``, ``fc2_*``; the
  128-row K12 tile and the 64 x 128 fc2 tile the rules dropped): their
  outputs must equal the tree's bit for bit (the fp32 folds follow the scale
  groups and hidden blocks, not the tiles);
* ``fc1_few_rows``: K13's fc1 on 16-row tiles at every row count;
* ``magic_int_to_float`` (each group sum to fp32 by an integer add and a
  float subtract of 1.5 * 2^23, not I2F) and ``magic_acc`` (the
  accumulators started at that constant's bits, the shift by 4 moved into
  the scales): bit-equal for groups up to 256 (PERF.md has their times);
* ``groups_*wave*``: K13's hidden groups dealt to fill another number of
  waves of fc2 blocks (``int4_block.FC2_WAVES``); another group count, so
  compared within a tolerance only;
* diagnostics whose outputs are wrong and not compared: ``no_mma`` (no
  tensor-core instruction; the fragments and the decode stay live),
  ``no_staging`` (no cp.async into the ring), ``no_decode`` (the packed
  words fed to the products as they are), ``no_fold`` (the group fold's
  product and sum replaced by one bitwise operation), ``fc1_only`` /
  ``fc2_only`` (K13's other launches left out). The differences in time
  say what each part costs inside the whole.
* ``--parent DIR``: the kernels of another checkout (``DIR`` a ``csrc``
  directory, for example of a ``git archive`` of the parent commit) through
  its own C entries, timed against the tree in turns: K12 and K4 must be
  bit-equal, K5 too, and K13 where both run one hidden group; the SASS of
  the int8 kernels (K3, K4, K5) of both libraries is compared function by
  function.

Each variant is built from a copy of the sources under ``tae_tpu_torch/_build/``
and loaded beside the tree's library; the two run in turns (tree, other,
other, tree) in one process on one card, each timed by the replay of a CUDA
graph of 20 launches (median of 7). Prints the card's name and power limit,
ptxas's report of the int4 kernels, and each time beside its bound.

    python -m tae_tpu_torch.bench.int4_body [--parent DIR] [--out FILE] [--cases TEXT] [variant ...]

Needs ``nvcc`` and a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

from tae_tpu_torch.bench.attention_body import time_ms
from tae_tpu_torch.bench.int8_body import build_variant, check, stream
from tae_tpu_torch.ops.cuda import build, int4_block
from tae_tpu_torch.ops.cuda.int4_block import mlp4_tiles
from tae_tpu_torch.ops.cuda.int4_matmul import pack_int4, w4_matmul_tiles
from tae_tpu_torch.ops.cuda.int8_block import mlp_hidden_groups, mlp_tiles
from tae_tpu_torch.ops.cuda.int8_matmul import matmul_tiles

HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12   # H100 SXM data sheet
KERNELS = ("int4_matmul", "int4_mlp")
INT8_KERNELS = ("int8_matmul", "int8_mlp", "ln_quant", "quantize_x")
BH = 256
GROUP = 256   # the scale group of every registered width (ops/int4.group_size)
# K12: (label, m, k, n, residual); bias always
K12_CASES = [("p16 qkv", 16384, 1024, 3072, False), ("p16 proj", 16384, 1024, 1024, True)]
for _m in (256, 32, 4):
    K12_CASES += [(f"p128 qkv M={_m}", _m, 2560, 7680, False),
                  (f"p128 proj M={_m}", _m, 2560, 2560, True)]
# K13: (label, m, d, hidden)
K13_CASES = [("p16", 16384, 1024, 4096)] + [(f"p128 M={m}", m, 2560, 10240)
                                            for m in (256, 32, 4)]

_VP, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of the first int4 design (a --parent checkout from before
# the int4 products ran on the int8 body): K12 took a flag for its small
# tiles, K13 a hidden-group workspace; the int8 entries are the tree's
PARENT_SIGNATURES = {
    "tae_int4_matmul_fwd": ((_VP,) * 7 + (_I,) * 7 + (_VP,), _I),
    "tae_int4_mlp_fwd": ((_VP,) * 10 + (_I,) * 7 + (_VP, _I, _VP), _I),
}

MM, BLK, COMMON, W4 = ("int4_matmul.cu", "int4_block.cu", "int8_common.cuh",
                      "int4_common.cuh")
K12_MANY = "using kMany = Tiles<64, 128, 2, 4, 5, 2>;"
K12_FEW = "using kFew = Tiles<16, 64, 1, 2, 4>;"
FC1_MANY = "using kFc1Many = Tiles<32, 256, 1, 8, 4, 2>;"
FC1_FEW = "using kFc1Few = Tiles<16, 256, 1, 8, 6>;"
FC2_MANY = "using kFc2Many = Tiles<64, 64, 2, 2, 4>;"
DECODE = ("          const unsigned b0 = (bw[ni][kk] << 4) & 0xF0F0F0F0u, "
          "b1 = bw[ni][kk] & 0xF0F0F0F0u;")
MMA4 = "          for (int mi = 0; mi < S::MI; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);"
FOLD_IG = "        const float ig = __int2float_rn(c[mi][ni][e] >> 4);"
# variant -> ([(file of csrc/, its text, the replacement), ...], outputs
# compared with the tree's bit for bit, {rule overrides})
VARIANTS = {
    "k12_many_128x128": ([(MM, K12_MANY, "using kMany = Tiles<128, 128, 4, 4, 4>;")], True, {}),
    "k12_many_4stages": ([(MM, K12_MANY, "using kMany = Tiles<64, 128, 2, 4, 4, 2>;")], True,
                         {}),
    "k12_few_16x128": ([(MM, K12_FEW, "using kFew = Tiles<16, 128, 1, 4, 4>;")], True, {}),
    "k12_few_8stages": ([(MM, K12_FEW, "using kFew = Tiles<16, 64, 1, 2, 8>;")], True, {}),
    "fc1_many_64x256": ([(BLK, FC1_MANY, "using kFc1Many = Tiles<64, 256, 2, 8, 3>;")], True,
                        {}),
    "fc1_few_4stages": ([(BLK, FC1_FEW, "using kFc1Few = Tiles<16, 256, 1, 8, 4>;")], True, {}),
    "fc1_few_rows": ([], True, {"fc1_tile": 1}),
    "fc2_many_64x128": ([(BLK, FC2_MANY, "using kFc2Many = Tiles<64, 128, 2, 4, 4>;")], True,
                        {}),
    "fc2_many_6stages": ([(BLK, FC2_MANY, "using kFc2Many = Tiles<64, 64, 2, 2, 6>;")], True,
                         {}),
    "magic_acc": ([(COMMON, "      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;",
                    "      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = B::kPacked ? 0x4B400000 : 0;"),
                   (W4, FOLD_IG, "        const float ig = __fsub_rn(__int_as_float(c[mi][ni][e]), "
                                 "12582912.0f);"),
                   (W4, "        c[mi][ni][e] = 0;", "        c[mi][ni][e] = 0x4B400000;"),
                   (W4, "    sc[ni] = col < cols ? *reinterpret_cast<const float2*>(s + col) : "
                        "make_float2(0.f, 0.f);",
                    "    sc[ni] = col < cols ? *reinterpret_cast<const float2*>(s + col) : "
                    "make_float2(0.f, 0.f);\n    sc[ni].x *= 0.0625f;\n    sc[ni].y *= 0.0625f;")],
                  True, {}),
    "groups_2waves": ([], False, {"waves": 2}),
    "groups_6waves": ([], False, {"waves": 6}),
    "groups_8waves": ([], False, {"waves": 8}),
    "magic_int_to_float": ([(W4, FOLD_IG, "        const float ig = __fsub_rn(__int_as_float("
                                          "0x4B400000 + (c[mi][ni][e] >> 4)), 12582912.0f);")],
                           True, {}),
    "no_fold": ([(W4, "        accf[mi][ni][e] = __fadd_rn(accf[mi][ni][e], __fmul_rn(ig, e % 2 ? "
                      "sc[ni].y : sc[ni].x));",
                  "        accf[mi][ni][e] = __int_as_float(__float_as_int(accf[mi][ni][e]) ^ "
                  "c[mi][ni][e]);")], False, {}),
    "no_mma": ([(COMMON, MMA4, "          for (int mi = 0; mi < S::MI; ++mi) acc[mi][ni][0] += "
                               "static_cast<int>(b0 ^ b1 ^ af[mi][0]);")], False, {}),
    "no_staging": ([(COMMON, "    cp_async16_zfill(d + i * kStep * LD, valid ? s + i * kStep * ld"
                             " : src, valid);\n", "")], False, {}),
    "no_decode": ([(COMMON, DECODE, "          const unsigned b0 = bw[ni][kk], b1 = b0;")],
                  False, {}),
    "fc1_only": ([(BLK, "  rc = p.g2 % kBK == 0", "  return 0;\n  rc = p.g2 % kBK == 0")],
                 False, {}),
    "fc2_only": ([(BLK, "  int rc = p.g1 % kBK == 0 ? launch_fc1_tiles<RowsI4<kBK>>(p, fc1_tiles, "
                        "stream)\n                           : launch_fc1_tiles<RowsI4<64>>(p, "
                        "fc1_tiles, stream);", "  int rc = 0;")], False, {}),
}


def load_parent(csrc: pathlib.Path) -> ctypes.CDLL:
    lib = build.load(build.build_library(build.BUILD_ROOT / "parent", csrc))
    for name, (argtypes, restype) in PARENT_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def ptxas_report(build_dir: pathlib.Path, kernels=KERNELS) -> list[str]:
    """ptxas's registers and spills of the named kernels' instantiations."""
    out, entry = [], ""
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif any(k in entry for k in kernels) and ("spill" in line or "registers" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def sass_functions(lib_path: pathlib.Path, kernels) -> dict[str, str]:
    """The SASS text of each function of the library whose name holds one of
    ``kernels``, by ``cuobjdump -sass``."""
    cuobjdump = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    found = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = fn.split("\n", 1)
        if any(k in name for k in kernels):
            # the anonymous namespace's name holds a hash of the file's path
            found[re.sub(r"_GLOBAL__N__\w+?_\d+_(\w+?)_cu_[0-9a-f]+", r"\1",
                         name.strip())] = body
    return found


def ri8(gen, shape, lim=127):
    return torch.randint(-lim, lim + 1, shape, generator=gen, device="cuda", dtype=torch.int8)


def rand(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


def randn(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k12_case(gen, label, m, k, n, residual, sms):
    """(label, {side: call(lib, rule) -> outputs}, bound ms, compare
    exactly), and the same for K4 on an int8 weight of the shape."""
    p = build.ptr
    x, sx = ri8(gen, (m, k)), rand(gen, (m, 1), 0.01, 0.06)
    w4 = pack_int4(ri8(gen, (n, k), 7))
    s4 = rand(gen, (k // GROUP, n), 2e-3, 9e-3)
    b = randn(gen, (n,))
    r = randn(gen, (m, n)) if residual else None
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

    def tree(lib, rule):
        check(lib, lib.tae_int4_matmul_fwd(
            x.data_ptr(), sx.data_ptr(), w4.data_ptr(), s4.data_ptr(), b.data_ptr(), p(r),
            out.data_ptr(), m, n, k, GROUP, 1, 1, w4_matmul_tiles(m, n, k), stream()),
            label)
        return (out,)

    def parent(lib, rule):
        small = -(-m // 128) * -(-n // 128) < sms
        check(lib, lib.tae_int4_matmul_fwd(
            x.data_ptr(), sx.data_ptr(), w4.data_ptr(), s4.data_ptr(), b.data_ptr(), p(r),
            out.data_ptr(), m, n, k, GROUP, 1, 1, int(small), stream()), label)
        return (out,)

    bnd = max(nbytes(x, sx, w4, s4, b, r, out) / HBM_BYTES_PER_S,
              2.0 * m * k * n / INT8_OPS_PER_S) * 1e3
    w8, s8 = ri8(gen, (n, k)), rand(gen, (n,), 1e-4, 5e-4)
    ws = torch.empty((1, m, n), dtype=torch.int32, device="cuda")
    out8 = torch.empty_like(out)

    def k4(lib, rule):
        tiles, splits = matmul_tiles(m, n, k, sms, False)
        check(lib, lib.tae_int8_matmul_fwd(
            x.data_ptr(), sx.data_ptr(), w8.data_ptr(), s8.data_ptr(), b.data_ptr(), p(r),
            out8.data_ptr(), m, n, k, 1, 1, 0, None, None, 1, 1e-6, None, None, tiles, splits,
            ws.data_ptr(), stream()), label)
        return (out8,)

    bnd8 = max(nbytes(x, sx, w8, s8, b, r, out8) / HBM_BYTES_PER_S,
               2.0 * m * k * n / INT8_OPS_PER_S) * 1e3
    return [(f"K12 {label} ({m}, {k}) x ({n}, {k})", {"tree": tree, "parent": parent}, bnd,
             True),
            (f"K4 {label} ({m}, {k}) x ({n}, {k})", {"tree": k4, "parent": k4}, bnd8, True)]


def k13_case(gen, label, m, d, hdim, sms):
    p = build.ptr
    xq, sx = ri8(gen, (m, d)), rand(gen, (m, 1), 0.005, 0.025)
    w1, w2 = pack_int4(ri8(gen, (hdim, d), 7)), pack_int4(ri8(gen, (d, hdim), 7))
    s1 = rand(gen, (d // GROUP, hdim), 6e-5, 2.7e-4)
    s2 = rand(gen, (hdim // GROUP, d), 6e-5, 2.7e-4)
    b1, b2, r = randn(gen, (hdim,), 0.1), randn(gen, (d,), 0.1), randn(gen, (m, d))
    out = torch.empty((m, d), dtype=torch.bfloat16, device="cuda")
    hq = torch.empty((m, hdim), dtype=torch.int8, device="cuda")
    sh = torch.empty((hdim // BH, m), dtype=torch.float32, device="cuda")
    part = torch.empty((hdim // BH, m, d), dtype=torch.float32, device="cuda")

    def common(w_1, w_2):
        return (xq.data_ptr(), sx.data_ptr(), w_1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                w_2.data_ptr(), s2.data_ptr(), b2.data_ptr(), r.data_ptr(), out.data_ptr(), m,
                d, hdim, GROUP, GROUP, 1, 1)

    def tree(lib, rule):
        waves, int4_block.FC2_WAVES = int4_block.FC2_WAVES, rule.get("waves",
                                                                     int4_block.FC2_WAVES)
        fc1, fc2, groups = mlp4_tiles(m, d, hdim, sms)
        int4_block.FC2_WAVES = waves
        fc1 = rule.get("fc1_tile", fc1)
        check(lib, lib.tae_int4_mlp_fwd(*common(w1, w2), hq.data_ptr(), sh.data_ptr(),
                                        part.data_ptr(), groups, fc1, fc2, stream()), label)
        return (out,)

    pgroups = mlp_hidden_groups(-(-m // 16), hdim // BH, sms)

    def parent(lib, rule):
        check(lib, lib.tae_int4_mlp_fwd(*common(w1, w2), part.data_ptr(), pgroups, stream()),
              label)
        return (out,)

    bnd = max(nbytes(xq, sx, w1, s1, b1, w2, s2, b2, r, out) / HBM_BYTES_PER_S,
              4.0 * m * d * hdim / INT8_OPS_PER_S) * 1e3
    w1_8, w2_8 = ri8(gen, (hdim, d)), ri8(gen, (d, hdim))
    sw1, sw2 = rand(gen, (hdim,), 1e-4, 5e-4), rand(gen, (d,), 1e-4, 5e-4)
    out8 = torch.empty_like(out)

    def k5(lib, rule):
        fc1, fc2, groups = mlp_tiles(m, d, hdim, BH, sms)
        check(lib, lib.tae_int8_mlp_fwd(
            xq.data_ptr(), sx.data_ptr(), w1_8.data_ptr(), sw1.data_ptr(), b1.data_ptr(),
            w2_8.data_ptr(), sw2.data_ptr(), b2.data_ptr(), r.data_ptr(), out8.data_ptr(), m, d,
            hdim, BH, 1, 1, None, None, 1, 1e-6, None, None, hq.data_ptr(), sh.data_ptr(),
            part.data_ptr(), groups, fc1, fc2, stream()), label)
        return (out8,)

    bnd8 = max(nbytes(xq, sx, w1_8, sw1, b1, w2_8, sw2, b2, r, out8) / HBM_BYTES_PER_S,
               4.0 * m * d * hdim / INT8_OPS_PER_S) * 1e3
    exact = mlp4_tiles(m, d, hdim, sms)[2] == 1 and pgroups == 1
    return [(f"K13 {label} ({m}, {d}) hidden {hdim}, parent groups {pgroups}",
             {"tree": tree, "parent": parent}, bnd, exact),
            (f"K5 {label} ({m}, {d}) hidden {hdim}", {"tree": k5, "parent": k5}, bnd8, True)]


def outputs(call, lib, rule):
    res = call(lib, rule)
    torch.cuda.synchronize()
    return [t.clone() for t in res]


def compare_sass(parent_dir: pathlib.Path) -> bool:
    """Whether the int8 kernels of the parent's library and the tree's
    compiled to the same SASS; prints each function that differs."""
    tree = sass_functions(build.BUILD_ROOT / build.source_hash() / build.LIB_NAME,
                          INT8_KERNELS)
    parent = sass_functions(build.BUILD_ROOT / "parent" / build.source_hash(parent_dir)
                            / build.LIB_NAME, INT8_KERNELS)
    same = sorted(tree) == sorted(parent)
    for name in sorted(set(tree) | set(parent)):
        if tree.get(name) != parent.get(name):
            same = False
            print(f"[sass] differs: {name[:120]}")
    print(f"[sass] int8 kernels ({len(tree)} functions): "
          f"{'identical to the parent' if same else 'DIFFERENT from the parent'}", flush=True)
    return same


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
    cases = [c for spec in K12_CASES for c in k12_case(gen, *spec, sms)]
    cases += [c for spec in K13_CASES for c in k13_case(gen, *spec, sms)]
    cases = [c for c in cases if args.cases in c[0]]
    names = (["parent"] if args.parent else []) + (
        args.variants or ([] if args.parent else list(VARIANTS)))
    sink = args.out.open("a") if args.out else None
    ok = True
    for name in names:
        rule = {}
        if name == "parent":
            lib, side, compared = load_parent(args.parent), "parent", True
            ok &= compare_sass(args.parent)
        else:
            edits, compared, rule = VARIANTS[name]
            lib, build_dir = build_variant(name, edits) if edits else (tree, None)
            side = "tree"
            if build_dir is not None and not name.startswith("no_"):
                for line in ptxas_report(build_dir):
                    print(f"[{name}] {line}")
        for label, calls, bnd, exact in cases:
            if name != "parent" and not label.startswith(("K12", "K13")):
                continue   # a variant of the int4 sources leaves K4 / K5 as they are
            want, got = outputs(calls["tree"], tree, {}), outputs(calls[side], lib, rule)
            same = all(torch.equal(a, b) for a, b in zip(want, got))
            diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(want, got))
            note = ""
            if compared or rule:
                if compared and exact:
                    ok &= same
                note = f"; bit-equal {same}" + ("" if same else f" (max |diff| {diff:.3g})")
            times = {0: [], 1: []}
            for kk, (one, call, rl) in ((0, (tree, calls["tree"], {})),
                                        (1, (lib, calls[side], rule)),
                                        (1, (lib, calls[side], rule)),
                                        (0, (tree, calls["tree"], {}))):
                times[kk].append(time_ms(lambda one=one, call=call, rl=rl: call(one, rl)))
            t0, t1 = statistics.mean(times[0]), statistics.mean(times[1])
            print(f"[{name}] {label}: tree {t0:.4f} ms ({times[0][0]:.4f}, {times[0][1]:.4f}), "
                  f"{name} {t1:.4f} ms ({times[1][0]:.4f}, {times[1][1]:.4f}); bound "
                  f"{bnd:.4f}{note}", flush=True)
            if sink:
                sink.write(json.dumps(dict(card=card, variant=name, case=label, tree_ms=times[0],
                                           other_ms=times[1], bound_ms=bnd, note=note)) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
