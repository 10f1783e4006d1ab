#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tae_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for fp32 matmuls and convolutions;
2. build: compiles the kernels in ``tae_tpu_torch/csrc/`` with nvcc for
   sm_90a and prints the seconds;
3. kernels: holds each of the nine kernels against its plain PyTorch version
   on the card at the slices' shapes, with the tolerances below, and prints
   the median time of both (CUDA events), the least time the card could
   take for the same work (the larger of bytes / 3.35 TB/s and operations /
   the tensor cores' peak), and the time of the one PyTorch call that
   computes the same function where there is one (a yardstick only). The
   four tiny-N / int8-output attention entries are also timed beside the
   per-image attention kernel (plus the plain per-row quantize) at the same
   shape: the measurements the dispatch rule of
   ``tae_tpu_torch.ops.attention.attention_route`` rests on;
4. paths (``PATHS``): for each model, built at full width with weights from
   ``torch.Generator("cuda").manual_seed(0)``, the bf16 and / or the int8
   (w8a8) ``Tokenizer`` answers encode, decode and reconstruct requests;
   checks shapes, finiteness, every kernel's launch count on every request,
   each output against the same model run with ``backend="reference"``, and
   the int8 outputs against the bf16 tokenizer's on the same weights. The
   int8 tokenizers are also timed with the int8-output attention forced on
   and off (``attn_q8``);
5. prints a JSON line with every kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

# (model, {depth overrides}, paths driven: tag -> quantization). p16 is the
# slice of the first two bring-ups; p128 and p32 run at full width and depth;
# p64 holds the wide int8 attention at 16 tokens and head dim 80 at a reduced
# depth (its blocks are p128's width).
PATHS = (
    ("tae_patch16_vocab256_px256", {}, {"bf16": None, "int8": "int8"}),
    ("tae_patch128_vocab4096_px256", {},
     {"p128_bf16": None, "p128_int8": "int8"}),
    ("tae_patch32_vocab1024_px256", {}, {"p32_int8": "int8"}),
    ("tae_patch64_vocab4096_px256", dict(depth=2, decoder_depth=2),
     {"p64_int8": "int8"}),
)
BATCHES = (1, 8, 64)         # encode / decode request sizes
KERNEL_BATCH = 64            # batch of the kernel-vs-plain shapes
TIMED_REPS = 20              # kernel timings: launches per replayed graph
GRAPH_REPLAYS = 7            # ... and the median of this many replays
REQUEST_REPS = 3             # slice timings: median of this many requests

# Kernel vs plain on the same card and inputs. Both compute in fp32 and
# round once; they differ only in fp32 summation order and in the last bit
# of exp/rsqrt, which in bf16 can flip one output rounding (one ulp is 2^-8
# relative, so 1e-2 allows about two) and in fp32 stays near 1e-6.
TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2),
       "float32": dict(atol=2e-5, rtol=1e-4)}
# Whole slice, kernels vs plain versions on the card, relative Frobenius
# error: the per-kernel bf16 rounding flips above feed through 15 residual
# blocks per half, each adding bf16-rounded matmul outputs of its own. A
# deeper model adds flips with every block: its bound is this one times
# depth / 15 (slice_tol).
SLICE_REL_TOL = 2e-2
SLICE_TOL_DEPTH = 15
# int8 kernels vs their plain versions. Both round the same fp32 values to
# codes; the values can differ in their last bits (summation order of the
# LayerNorm statistics, tanhf), so one within that of a rounding tie lands
# on the neighbouring code: codes may differ by 1 on at most
# CODE_FLIP_SHARE of the elements. Scales are max-reductions of such
# values (rtol 1e-5). The float outputs follow TOL.
CODE_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-5
# K5 requantizes its hidden activation inside: a hidden code on a rounding
# tie flips and moves its whole output row, and so that row's chained LN
# scale, by one hidden quantization step (measured: up to 2.7e-4 relative,
# on 3-5 rows of 16384).
MLP_SCALE_RTOL = 1e-3
# The int8-output attention entries (K7-K9) in bf16: the P.V product takes p
# rounded to bf16, and the fp32 p of kernel and plain version differ in their
# last bits (summation order of the scores), so a p within that of a bf16
# rounding boundary rounds to the neighbouring value on one side. One such
# flip moves that head's outputs of that row by up to 2^-7 * (p / l) * |v|,
# and so the row's scale where its largest output sits in that head
# (measured at B = 64: 0.2% of the rows beyond SCALE_RTOL, the worst by
# 6e-3 relative; no code off by more than one). Scales agree to SCALE_RTOL
# on all but ATTN_SCALE_SHARE of the rows and to ATTN_SCALE_RTOL (2^-7 times
# |v| / max|o| up to 2.5) on every row. In fp32 p is not rounded and the
# scales agree to SCALE_RTOL throughout.
ATTN_SCALE_SHARE = 1e-2
ATTN_SCALE_RTOL = 2e-2
# int8 tokenizer vs the bf16 tokenizer on the same weights, relative
# Frobenius error: w8a8 quantization noise through 15 blocks per half (the
# JAX package's tests accept 0.03-0.05 on 2-3 layer models).
INT8_VS_BF16_TOL = 0.1
# The int8 slice, kernels vs plain versions on the card: the bf16 slice's
# rounding flips (attention and the bf16 casts are the same code), each of
# which also moves int8 codes in the layers after it (measured 0.018-0.021).
INT8_SLICE_REL_TOL = 4e-2

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}

K1 = dict(name="fused_layer_norm", route="cuda",
          source="tae_tpu_torch/csrc/layernorm.cu",
          replaces="tae_tpu/ops/pallas/layernorm.py:24")
K2 = dict(name="fused_qkv_attention", route="cuda",
          source="tae_tpu_torch/csrc/flash_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:244")
K3 = dict(name="ln_quant", route="cuda",
          source="tae_tpu_torch/csrc/int8_block.cu",
          replaces="tae_tpu/ops/pallas/int8_block.py:48")
K4 = dict(name="int8_matmul_fused", route="cuda",
          source="tae_tpu_torch/csrc/int8_matmul.cu",
          replaces="tae_tpu/ops/pallas/int8_matmul.py:32")
K5 = dict(name="int8_mlp", route="cuda",
          source="tae_tpu_torch/csrc/int8_block.cu",
          replaces="tae_tpu/ops/pallas/int8_block.py:111")
K6 = dict(name="fused_qkv_attention_wide", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:307")
K7 = dict(name="fused_qkv_attention_q8", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:417")
K8 = dict(name="fused_qkv_attention_wide_q8", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:472")
K9 = dict(name="fused_qkv_attention_wide_q8_2d", route="cuda",
          source="tae_tpu_torch/csrc/wide_attention.cu",
          replaces="tae_tpu/ops/pallas/flash_attention.py:543")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card and never runs on the CPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")


def phase_build():
    from tae_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.build_library()
    build.library()
    print(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(build.PACKAGE_DIR.parent)}")
    entry = ""
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line or "registers" in line:
            print(f"[build] {entry}: {line.strip()}")


def time_ms(fn) -> float:
    """Device time of one call of ``fn`` in ms: TIMED_REPS calls are captured
    in a CUDA graph after a warm-up, the graph is replayed GRAPH_REPLAYS
    times between CUDA events, and the median replay is divided by the
    calls. A replay has no host work between the launches, so a kernel of a
    few microseconds is not measured as its wrapper's Python time (a single
    launch between two events reads 0.03-0.05 ms for any small kernel)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_REPS):
            fn()
    graph.replay()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_REPS)
    return statistics.median(times)


def compare(label: str, got, want, atol: float, rtol: float) -> float:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float(err.max())
    check(bool((err <= bound).all()),
          f"{label}: max |kernel - plain| {worst:.3g} exceeds atol {atol} "
          f"+ rtol {rtol}")
    return worst


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what binds): each input read once and
    each output written once at the memory rate, against the operations at
    the tensor cores' peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_codes(label: str, got, want) -> float:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.int8,
          f"{label}: {tuple(got.shape)} {got.dtype}")
    diff = (got.int() - want.int()).abs()
    share = float((diff > 0).float().mean())
    check(int(diff.max()) <= 1 and share <= CODE_FLIP_SHARE,
          f"{label}: codes differ by up to {int(diff.max())} on a share "
          f"{share:.3g} of elements (allowed: 1 on {CODE_FLIP_SHARE})")
    return share


def compare_scales(label: str, got, want, rtol: float = SCALE_RTOL,
                   loose_share: float = 0.0, loose_rtol: float = 0.0) -> float:
    """Scales agree to ``rtol``; with ``loose_share``, that share of them may
    differ by up to ``loose_rtol`` instead. Returns the worst relative
    difference."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.float32,
          f"{label}: {tuple(got.shape)} {got.dtype}")
    rel = (got - want).abs() / want.abs()
    worst, beyond = float(rel.max()), float((rel > rtol).float().mean())
    check(beyond <= loose_share and worst <= max(rtol, loose_rtol),
          f"{label}: scales differ by up to {worst:.3g} relative, a share "
          f"{beyond:.3g} of them beyond {rtol} (allowed: {loose_share} up to "
          f"{loose_rtol})")
    return worst


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import (
        fused_qkv_attention, fused_qkv_attention_reference)
    from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
    from tae_tpu_torch.ops.layernorm import layer_norm_reference

    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {"fused_layer_norm": [], "fused_qkv_attention": []}

    def randn(shape, dtype, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale + shift).to(dtype)

    d = 1024
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        x = randn((KERNEL_BATCH * 256, d), dtype, 3.0, 1.0)
        w, b = randn((d,), dtype, 1.0, 1.0), randn((d,), dtype)
        got = fused_layer_norm(x, w, b, 1e-6)
        want = layer_norm_reference(x, w, b, 1e-6)
        err = compare(f"K1 {tuple(x.shape)} {dtype}", got, want, **tol)
        ms = time_ms(lambda: fused_layer_norm(x, w, b, 1e-6))
        plain = time_ms(lambda: layer_norm_reference(x, w, b, 1e-6))
        lib = time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6))
        bnd = bound(nbytes(x, w, b, got), 0.0, "bf16")
        res["fused_layer_norm"].append((dtype, err, ms, plain, bnd, lib))
        print(f"[kernels] K1 layer_norm {tuple(x.shape)} {dtype}: max_abs_err "
              f"{err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}); kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), F.layer_norm {lib:.4f} ms")

    # the slice's shape, a dh=80 shape (p64 configs), and N=4 (p128), which
    # pads the token axis to the kernel's 16-row tiles
    for n, h, dh in ((256, 16, 64), (16, 32, 80), (4, 32, 80)):
        c = h * dh
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[1]]
            qkv = randn((KERNEL_BATCH, n, 3 * c), dtype)
            for serving in (True, False):
                got = fused_qkv_attention(qkv, h, serving=serving)
                want = fused_qkv_attention_reference(qkv, h, serving=serving)
                mode = "serving" if serving else "exact"
                err = compare(f"K2 {tuple(qkv.shape)} h{h} {dtype} {mode}",
                              got, want, **tol)
                ms = time_ms(lambda: fused_qkv_attention(qkv, h,
                                                         serving=serving))
                plain = time_ms(lambda: fused_qkv_attention_reference(
                    qkv, h, serving=serving))
                bnd = bound(nbytes(qkv, got),
                            4.0 * KERNEL_BATCH * h * n * n * dh, "bf16")
                lib = None
                if not serving:
                    # the library call has only the exact softmax
                    r = qkv.view(KERNEL_BATCH, n, 3, h, dh).permute(2, 0, 3, 1, 4)
                    lib = time_ms(lambda: F.scaled_dot_product_attention(
                        r[0], r[1], r[2]))
                res["fused_qkv_attention"].append(
                    (dtype, err, ms, plain, n, serving, bnd, lib))
                lib_s = "" if lib is None else f", SDPA {lib:.4f} ms"
                print(f"[kernels] K2 attention {tuple(qkv.shape)} h={h} "
                      f"dh={dh} {dtype} {mode}: max_abs_err {err:.3g} "
                      f"(atol {tol['atol']}, rtol {tol['rtol']}); kernel "
                      f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
                      f"{bnd[0]:.4f} ms ({bnd[1]}){lib_s}")
    return res


def phase_int8_kernels() -> dict:
    """K3, K4 and K5 against their plain versions at the int8 slice's shapes
    (B = 64: M = 16384 rows) and at one odd row count each. Returns one
    list of case records per kernel; the first is the main-path shape."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.int8_block import (
        int8_mlp, int8_mlp_reference, ln_quant, ln_quant_reference)
    from tae_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul_fused, int8_matmul_reference)
    from tae_tpu_torch.ops.int8 import DEFAULT_BLOCK_H, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    m_full, d, hdim = KERNEL_BATCH * 256, 1024, 4096
    res = {"ln_quant": [], "int8_matmul_fused": [], "int8_mlp": []}

    def randn(shape, scale=1.0, shift=0.0, dtype=bf16):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x * scale + shift).to(dtype)

    def rand_i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    def record(kernel, label, err, ms, plain, bnd, lib=None, extra=""):
        res[kernel].append(dict(case=label, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=bnd[0],
                                bound_by=bnd[1], library_ms=lib))
        timing = "" if ms is None else (
            f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        print(f"[kernels] {label}: max_abs_err {err:.3g}{timing}{extra}")

    # ---- K3
    g, be = randn((d,), 0.5, 1.0), randn((d,), 0.2)
    for m in (m_full, 1001):
        x = randn((m, d), 3.0, 1.0)
        q, s = ln_quant(x, g, be, 1e-6)
        q_ref, s_ref = ln_quant_reference(x, g, be, 1e-6)
        label = f"K3 ln_quant ({m}, {d}) bf16"
        compare_scales(label, s, s_ref)
        share = compare_codes(label, q, q_ref)
        err = float((q.float() * s - q_ref.float() * s_ref).abs().max())
        timed = m == m_full
        record("ln_quant", label, err,
               time_ms(lambda: ln_quant(x, g, be, 1e-6)) if timed else None,
               time_ms(lambda: ln_quant_reference(x, g, be, 1e-6))
               if timed else None,
               bound(nbytes(x, g, be, q, s), 0.0, "int8"),
               extra=f"; codes off by one on a share {share:.2g}")

    # ---- K4: the five products of the main path, then the epilogue forms
    #      on the proj shape, then an odd row count
    def k4_case(name, m, k, n, bias, residual, ln, timed=True, lib=False):
        xq, sx = rand_i8((m, k)), scales((m, 1), 0.01, 0.06)
        wq, sw = rand_i8((n, k)), scales((n,), 1e-4, 5e-4)
        b = randn((n,)) if bias else None
        r = randn((m, n)) if residual else None
        ln_out = (randn((n,), 0.5, 1.0), randn((n,), 0.2), 1e-6) if ln else None
        got = int8_matmul_fused(xq, sx, wq, sw, b, r, bf16, ln_out)
        want = int8_matmul_reference(xq, sx, wq, sw, b, r, bf16, ln_out)
        label = (f"K4 int8_matmul {name} ({m}, {k}) x ({n}, {k})"
                 f"{' +bias' if bias else ''}{' +residual' if residual else ''}"
                 f"{' +ln_out' if ln else ''}")
        extra, outs = "", [got]
        if ln:
            compare_scales(label, got[2], want[2])
            share = compare_codes(label, got[1], want[1])
            extra = f"; ln_out codes off by one on a share {share:.2g}"
            outs, got, want = list(got), got[0], want[0]
        err = compare(label, got, want, **tol)
        lib_ms = None
        if lib:
            lib_ms = time_ms(lambda: torch._int_mm(xq, wq.t()))
            extra += f"; torch._int_mm (product only) {lib_ms:.4f} ms"
        record("int8_matmul_fused", label, err,
               time_ms(lambda: int8_matmul_fused(xq, sx, wq, sw, b, r, bf16,
                                                 ln_out)) if timed else None,
               time_ms(lambda: int8_matmul_reference(xq, sx, wq, sw, b, r,
                                                     bf16, ln_out))
               if timed else None,
               bound(nbytes(xq, sx, wq, sw, b, r, *outs)
                     + (nbytes(*ln_out[:2]) if ln else 0),
                     2.0 * m * k * n, "int8"), lib_ms, extra)

    k4_case("qkv", m_full, d, 3 * d, True, False, False, lib=True)
    k4_case("proj", m_full, d, d, True, True, True, lib=True)
    k4_case("dict_proj", m_full, d, 256, False, False, False)
    k4_case("embed", m_full, 256, d, True, False, False)
    k4_case("pred", m_full, d, 768, True, False, False)
    k4_case("proj", m_full, d, d, True, False, False)
    k4_case("proj", m_full, d, d, True, True, False)
    k4_case("odd M", 1001, d, d, True, True, True, timed=False)
    k4_case("odd M", 1001, d, 3 * d, True, False, False, timed=False)

    # ---- K5
    w1, s1 = rand_i8((hdim, d)), scales((hdim,), 1e-4, 5e-4)
    w2, s2 = rand_i8((d, hdim)), scales((d,), 1e-4, 5e-4)
    b1, b2 = randn((hdim,), 0.1), randn((d,), 0.1)
    ln_next = (g, be, 1e-6)
    bh = DEFAULT_BLOCK_H
    for m, ln in ((m_full, ln_next), (m_full, None), (1001, ln_next)):
        xq, sx = rand_i8((m, d)), scales((m, 1), 0.005, 0.025)
        r = randn((m, d))
        args = (xq, sx, w1, s1, b1, w2, s2, b2, r, bh, bf16, ln)
        got, want = int8_mlp(*args), int8_mlp_reference(*args)
        label = (f"K5 int8_mlp ({m}, {d}) hidden {hdim} block_h {bh}"
                 f"{' +ln_next' if ln else ''}")
        extra, outs = "", [got]
        if ln:
            compare_scales(label, got[2], want[2], MLP_SCALE_RTOL)
            share = compare_codes(label, got[1], want[1])
            extra = f"; ln_next codes off by one on a share {share:.2g}"
            outs, got, want = list(got), got[0], want[0]
        err = compare(label, got, want, **tol)
        timed = m == m_full
        record("int8_mlp", label, err,
               time_ms(lambda: int8_mlp(*args)) if timed else None,
               time_ms(lambda: int8_mlp_reference(*args)) if timed else None,
               bound(nbytes(xq, sx, w1, s1, b1, w2, s2, b2, r, *outs)
                     + (nbytes(g, be) if ln else 0),
                     4.0 * m * d * hdim, "int8"), None, extra)

    # the same MLP unfused, as a yardstick for K5: K4, GELU and a whole-row
    # quantize in plain PyTorch, K4 with the residual (other numerics: one
    # hidden scale per row)
    xq, sx = rand_i8((m_full, d)), scales((m_full, 1), 0.005, 0.025)
    r = randn((m_full, d))

    def unfused():
        h = int8_matmul_fused(xq, sx, w1, s1, b1, None, bf16)
        hq, sh = quantize_rows(F.gelu(h, approximate="tanh"))
        return int8_matmul_fused(hq, sh, w2, s2, b2, r, bf16)

    ms = time_ms(unfused)
    res["int8_mlp"][0]["unfused_ms"] = ms
    print(f"[kernels] K5 yardstick: the MLP unfused (K4, plain GELU and "
          f"quantize, K4) at ({m_full}, {d}) hidden {hdim}: {ms:.4f} ms")
    return res


def phase_attention_kernels() -> dict:
    """K6-K9 against their plain versions at the shapes of the tiny-N and
    int8 paths (B = 64) and at an odd batch each, and beside the per-image
    kernel K2 (plus the plain per-row quantize for the int8-output entries)
    at the same shape. Returns one list of case records per kernel; the
    first is the shape of that kernel's full-depth path."""
    import torch
    import torch.nn.functional as F

    from tae_tpu_torch.ops.cuda.flash_attention import fused_qkv_attention
    from tae_tpu_torch.ops.cuda.wide_attention import (
        fused_qkv_attention_q8, fused_qkv_attention_q8_reference,
        fused_qkv_attention_wide, fused_qkv_attention_wide_q8,
        fused_qkv_attention_wide_q8_2d,
        fused_qkv_attention_wide_q8_2d_reference,
        fused_qkv_attention_wide_q8_reference,
        fused_qkv_attention_wide_reference)
    from tae_tpu_torch.ops.int8 import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(2468)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    res = {k["name"]: [] for k in (K6, K7, K8, K9)}
    odd = 7

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def record(kernel, label, err, timing, extra=""):
        res[kernel].append(dict(case=label, max_abs_err=err, **timing))
        line = ""
        if timing["ms"] is not None:
            line = (f"; kernel {timing['ms']:.4f} ms, plain "
                    f"{timing['plain_ms']:.4f} ms, bound "
                    f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
        print(f"[kernels] {label}: max_abs_err {err:.3g}{line}{extra}")

    def timing(fn, plain, qkv, outs, h, n, dh, timed):
        b = qkv.numel() // (n * 3 * h * dh)
        bnd = bound(nbytes(qkv, *outs), 4.0 * b * h * n * n * dh, "bf16")
        return dict(ms=time_ms(fn) if timed else None,
                    plain_ms=time_ms(plain) if timed else None,
                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)

    def compare_q8(label, got, want) -> tuple[float, float]:
        (q, s), (q_ref, s_ref) = got, want
        compare_scales(label, s, s_ref, SCALE_RTOL, ATTN_SCALE_SHARE,
                       ATTN_SCALE_RTOL)
        share = compare_codes(label, q, q_ref)
        return float((q.float() * s - q_ref.float() * s_ref).abs().max()), share

    # ---- K6, bf16 output: p128, p64 and p32 shapes, and 8 tokens (the last
    #      count at which images share a tile); both softmax forms
    for n, h, dh in ((4, 32, 80), (8, 32, 80), (16, 32, 80), (64, 32, 64)):
        for b in (KERNEL_BATCH, odd):
            qkv = randn((b, n, 3 * h * dh))
            for serving in (True, False):
                got = fused_qkv_attention_wide(qkv, h, serving=serving)
                want = fused_qkv_attention_wide_reference(qkv, h,
                                                          serving=serving)
                mode = "serving" if serving else "exact"
                label = f"K6 wide {tuple(qkv.shape)} h={h} dh={dh} bf16 {mode}"
                err = compare(label, got, want, **tol)
                timed = b == KERNEL_BATCH
                t = timing(lambda: fused_qkv_attention_wide(qkv, h,
                                                            serving=serving),
                           lambda: fused_qkv_attention_wide_reference(
                               qkv, h, serving=serving),
                           qkv, [got], h, n, dh, timed)
                extra = ""
                if timed:
                    t["k2_ms"] = time_ms(lambda: fused_qkv_attention(
                        qkv, h, serving=serving))
                    extra = f"; K2 at this shape {t['k2_ms']:.4f} ms"
                    if not serving:
                        # the library call has only the exact softmax
                        r = qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
                        t["library_ms"] = time_ms(
                            lambda: F.scaled_dot_product_attention(
                                r[0], r[1], r[2]))
                        extra += f", SDPA {t['library_ms']:.4f} ms"
                record(K6["name"], label, err, t, extra)

    # ---- int8 output: K7 at the p16 shape; K8 at the p32 and p64 shapes;
    #      K9 (flat rows) at the p128 shape. K2 + the plain quantize is what
    #      each replaces.
    def q8_case(meta, fn, plain, n, h, dh, b, flat):
        qkv = randn((b, n, 3 * h * dh))
        arg = (qkv.reshape(b * n, -1), n, h) if flat else (qkv, h)
        got, want = fn(*arg), plain(*arg)
        label = (f"{meta['name'].replace('fused_qkv_attention', 'attention')} "
                 f"{tuple(arg[0].shape)} n={n} h={h} dh={dh} bf16")
        err, share = compare_q8(label, got, want)
        timed = b == KERNEL_BATCH
        t = timing(lambda: fn(*arg), lambda: plain(*arg), qkv, got, h, n, dh,
                   timed)
        extra = f"; codes off by one on a share {share:.2g}"
        if timed:
            t["k2_quantize_ms"] = time_ms(lambda: quantize_rows(
                fused_qkv_attention(qkv, h, serving=True)))
            extra += (f"; K2 + plain quantize_rows at this shape "
                      f"{t['k2_quantize_ms']:.4f} ms")
        record(meta["name"], label, err, t, extra)
        return qkv, got

    for b in (KERNEL_BATCH, odd):
        q8_case(K7, fused_qkv_attention_q8, fused_qkv_attention_q8_reference,
                256, 16, 64, b, False)
    for n, h, dh in ((64, 32, 64), (16, 32, 80), (4, 32, 80)):
        for b in (KERNEL_BATCH, odd):
            qkv, (q3, s3) = q8_case(K8, fused_qkv_attention_wide_q8,
                                    fused_qkv_attention_wide_q8_reference,
                                    n, h, dh, b, False)
            # the flat entry on the same bytes: equal bit for bit
            q2, s2 = fused_qkv_attention_wide_q8_2d(qkv.reshape(b * n, -1), n, h)
            check(torch.equal(q2, q3.reshape(b * n, -1))
                  and torch.equal(s2, s3.reshape(b * n, 1)),
                  f"K9 differs from K8 at n={n} B={b}")
    print("[kernels] K9 (flat rows) equals K8 bit for bit at n = 64, 16, 4, "
          f"B = {KERNEL_BATCH} and {odd}")
    for b in (KERNEL_BATCH, odd):
        q8_case(K9, fused_qkv_attention_wide_q8_2d,
                fused_qkv_attention_wide_q8_2d_reference, 4, 32, 80, b, True)

    # ---- the serving clamp: every score far below -60 (aligned q rows
    #      against anti-aligned k rows) stays finite and equals the plain form
    n, h, dh = 4, 2, 64
    c = h * dh
    qkv = torch.zeros((6, n, 3 * c), device="cuda")
    qkv[:, :, :c], qkv[:, :, c:2 * c] = 40.0, -40.0
    qkv[:, :, 2 * c:] = torch.randn((6, n, c), generator=gen, device="cuda")
    qkv = qkv.to(bf16)
    for serving in (True, False):
        compare(f"K6 clamp case serving={serving}",
                fused_qkv_attention_wide(qkv, h, serving=serving),
                fused_qkv_attention_wide_reference(qkv, h, serving=serving),
                **tol)
    compare_q8("K8 clamp case", fused_qkv_attention_wide_q8(qkv, h),
               fused_qkv_attention_wide_q8_reference(qkv, h))
    compare_q8("K9 clamp case",
               fused_qkv_attention_wide_q8_2d(qkv.reshape(6 * n, -1), n, h),
               fused_qkv_attention_wide_q8_2d_reference(
                   qkv.reshape(6 * n, -1), n, h))
    print("[kernels] K6, K8, K9 on scores below the clamp: finite, equal to "
          "the plain versions")
    return res


def slice_tol(base: float, cfg) -> float:
    """The whole-slice bound for a model of cfg.depth blocks per half."""
    return base * max(1.0, cfg.depth / SLICE_TOL_DEPTH)


def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def wrappers() -> dict:
    """The kernel wrappers by name; each counts its launches."""
    from tae_tpu_torch.ops.cuda.flash_attention import fused_qkv_attention
    from tae_tpu_torch.ops.cuda.int8_block import int8_mlp, ln_quant
    from tae_tpu_torch.ops.cuda.int8_matmul import int8_matmul_fused
    from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
    from tae_tpu_torch.ops.cuda.wide_attention import (
        fused_qkv_attention_q8, fused_qkv_attention_wide,
        fused_qkv_attention_wide_q8, fused_qkv_attention_wide_q8_2d)

    return {f.__name__: f for f in (
        fused_layer_norm, fused_qkv_attention, ln_quant, int8_matmul_fused,
        int8_mlp, fused_qkv_attention_wide, fused_qkv_attention_q8,
        fused_qkv_attention_wide_q8, fused_qkv_attention_wide_q8_2d)}


def phase_slice(tag: str, tok, per_call: dict, rel_tol: float,
                against=None) -> tuple[dict, dict]:
    """Drive one tokenizer's main path: encode and decode at every batch
    size, one reconstruct. ``per_call`` gives each kernel's launches per
    encode and per decode call, checked on every request. Outputs are held
    against the same tokenizer with ``backend="reference"`` (bound
    ``rel_tol``) and, with ``against = (other tokenizer, bound)``, against
    that one. Returns (launch counts of the run, latents by batch)."""
    import torch

    from tae_tpu_torch.tokenizer import Tokenizer

    fns = wrappers()
    cfg = tok.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = {b: torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                               dtype=torch.uint8, device="cuda", generator=gen)
              for b in BATCHES}

    def counts():
        return {name: f.launches for name, f in fns.items()}

    def request(fn, arg, kinds):
        """One request, timed on the host clock to a synchronize; checks
        that it launched each kernel exactly as often as the path runs it."""
        before = counts()
        t = time.perf_counter()
        out = fn(arg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = counts()
        for name in fns:
            want = sum(per_call[kind].get(name, 0) for kind in kinds)
            got = after[name] - before[name]
            check(got == want, f"{tag} {fn.__name__}: {got} {name} launches, "
                               f"expected {want}")
        return out, dt

    # ---- the main path: every count is 0 here and read right after
    request(tok.encode, images[1], ("encode",))          # warm-up request
    for f in fns.values():
        f.launches = 0
    latents, recon, enc_lat, dec_lat = {}, {}, {}, {}
    for b in BATCHES:
        runs = [request(tok.encode, images[b], ("encode",))
                for _ in range(REQUEST_REPS)]
        latents[b] = runs[-1][0]
        enc_lat[b] = statistics.median(dt for _, dt in runs)
    for b in BATCHES:
        runs = [request(tok.decode, latents[b], ("decode",))
                for _ in range(REQUEST_REPS)]
        recon[b] = runs[-1][0]
        dec_lat[b] = statistics.median(dt for _, dt in runs)
    rec_b = BATCHES[1]
    rec, _ = request(tok.reconstruct, images[rec_b], ("encode", "decode"))
    launches = counts()
    on_path = {n for kind in per_call.values() for n, c in kind.items() if c}
    check(all(launches[n] > 0 for n in on_path),
          f"{tag}: a kernel of the path never launched: {launches}")
    print(f"[{tag}] main path launches: {json.dumps(launches)} "
          f"(per call: {json.dumps(per_call)})")

    for b in BATCHES:
        print(f"[{tag}] encode B={b}: {enc_lat[b] * 1e3:.2f} ms/request, "
              f"{b / enc_lat[b]:.1f} img/s; decode B={b}: "
              f"{dec_lat[b] * 1e3:.2f} ms/request, {b / dec_lat[b]:.1f} img/s")

    # ---- outputs: shapes, finiteness, against the plain versions
    ref = Tokenizer(model=tok.model, policy=tok.policy, backend="reference")
    n, v = cfg.num_patches, cfg.vocab_size
    for b in BATCHES:
        z, x = latents[b], recon[b]
        check(tuple(z.shape) == (b, n, v) and z.dtype == torch.bfloat16,
              f"latents {tuple(z.shape)} {z.dtype}")
        check(tuple(x.shape) == (b, 3, cfg.img_size, cfg.img_size),
              f"reconstruction {tuple(x.shape)}")
        check(bool(torch.isfinite(z).all() and torch.isfinite(x).all()),
              f"non-finite output at B={b}")
        ez = rel_err(z, ref.encode(images[b]))
        ex = rel_err(x, ref.decode(z))
        print(f"[{tag}] B={b}: latents rel_err {ez:.3g}, decode rel_err "
              f"{ex:.3g} vs backend='reference' (tolerance {rel_tol:.3g})")
        check(ez <= rel_tol and ex <= rel_tol,
              f"{tag} B={b}: kernels disagree with the plain versions")
        if against is not None:
            other, bound_other = against
            ez = rel_err(z, other.encode(images[b]))
            ex = rel_err(x, other.decode(z))
            print(f"[{tag}] B={b}: latents rel_err {ez:.3g}, decode rel_err "
                  f"{ex:.3g} vs the bf16 tokenizer on the same weights "
                  f"(tolerance {bound_other})")
            check(ez <= bound_other and ex <= bound_other,
                  f"{tag} B={b}: int8 outputs too far from bf16")
    er = rel_err(rec, ref.reconstruct(images[rec_b]))
    check(tuple(rec.shape) == (rec_b, 3, cfg.img_size, cfg.img_size)
          and er <= rel_tol, f"{tag} reconstruct rel_err {er:.3g}")
    print(f"[{tag}] reconstruct B={rec_b}: rel_err {er:.3g}")
    return launches, latents


def expected_launches(cfg, quantization, attn_q8=None) -> dict:
    """Each kernel's launches per encode and per decode call, as the code
    implies them: the attention entry from the dispatch rule; in bf16 a
    LayerNorm kernel per norm; in int8 every LayerNorm rides a quantizing
    kernel (the MLP epilogue always chains the next LN; the proj epilogue
    chains norm2 where the shape rule allows, else ln_quant runs once more
    per block)."""
    from tae_tpu_torch.ops.attention import ROUTES, attention_route
    from tae_tpu_torch.ops.cuda.int8_matmul import ln_chain_rows

    depth = cfg.depth  # decoder depth is equal for every registered config
    route, _ = attention_route(cfg.num_patches, quantization is not None,
                               True, attn_q8)
    attention = ROUTES[route][0].__name__
    if quantization is None:
        half = {attention: depth, "fused_layer_norm": 2 * depth + 1}
        return {"encode": half, "decode": half}
    chained = ln_chain_rows(cfg.embed_dim) is not None
    enc = {"ln_quant": 1 if chained else 1 + depth,
           "int8_matmul_fused": 2 * depth + 1, "int8_mlp": depth,
           attention: depth}
    return {"encode": enc, "decode": dict(enc, int8_matmul_fused=2 * depth + 2)}


def time_attn_q8(tag: str, tok) -> dict:
    """Encode requests at the largest batch with the int8-output attention
    forced on, off, off, on (one card, in turns): median ms per request of
    each setting, launch counts checked. The tokenizer is left on the rule."""
    import torch

    from tae_tpu_torch.tokenizer import set_attn_q8

    fns, cfg, b = wrappers(), tok.model.cfg, BATCHES[-1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randint(0, 256, (b, 3, cfg.img_size, cfg.img_size),
                           dtype=torch.uint8, device="cuda", generator=gen)
    times = {True: [], False: []}
    for q8 in (True, False, False, True):
        set_attn_q8(tok.model, q8)
        want = expected_launches(cfg, "int8", q8)["encode"]
        tok.encode(images)
        for _ in range(REQUEST_REPS):
            before = {name: f.launches for name, f in fns.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok.encode(images)
            torch.cuda.synchronize()
            times[q8].append((time.perf_counter() - t) * 1e3)
            got = {name: f.launches - before[name] for name, f in fns.items()}
            check(got == {name: want.get(name, 0) for name in fns},
                  f"{tag} attn_q8={q8}: launches {got}, expected {want}")
    set_attn_q8(tok.model, None)
    on, off = (statistics.median(times[q]) for q in (True, False))
    print(f"[{tag}] encode B={b}: int8-output attention {on:.2f} ms/request "
          f"(runs {min(times[True]):.2f}-{max(times[True]):.2f}); attention in "
          f"bf16 + plain quantize_rows {off:.2f} ms/request (runs "
          f"{min(times[False]):.2f}-{max(times[False]):.2f})")
    return {"attn_q8_ms": on, "bf16_attn_plain_quantize_ms": off}


def phase_paths() -> dict:
    """Every model of PATHS: its bf16 tokenizer (driven where PATHS names a
    bf16 path, and the yardstick of the int8 outputs), then its int8
    tokenizer on the same weights. Returns each path's launch counts."""
    import gc

    import torch

    from tae_tpu_torch.nn.vit import QLinear
    from tae_tpu_torch.tokenizer import Tokenizer

    launches = {}
    for name, overrides, paths in PATHS:
        def build(**kw):
            t0 = time.perf_counter()
            tok = Tokenizer.from_checkpoint(name, dtype=torch.bfloat16,
                                            device="cuda", seed=0, **overrides,
                                            **kw)
            torch.cuda.synchronize()
            return tok, time.perf_counter() - t0

        tok, secs = build()
        cfg = tok.model.cfg
        n_params = sum(p.numel() for p in tok.model.parameters())
        print(f"[paths] {name}: {n_params} params, width {cfg.embed_dim}, "
              f"{cfg.depth}+{cfg.decoder_depth} blocks, {cfg.num_heads} heads "
              f"of {cfg.embed_dim // cfg.num_heads}, {cfg.num_patches} tokens, "
              f"bf16, built in {secs:.1f} s")
        tok8 = None
        for tag, quantization in paths.items():
            if quantization is None:
                launches[tag], _ = phase_slice(
                    tag, tok, expected_launches(cfg, None),
                    slice_tol(SLICE_REL_TOL, cfg))
                continue
            tok8, secs = build(quantization=quantization)
            n_q = sum(isinstance(m, QLinear) for m in tok8.model.modules())
            print(f"[{tag}] {n_q} int8 linears (w8a8), MLP block_h "
                  f"{tok8.model.blocks[0].mlp.block_h}, built and quantized in "
                  f"{secs:.1f} s")
            launches[tag], _ = phase_slice(
                tag, tok8, expected_launches(cfg, quantization),
                slice_tol(INT8_SLICE_REL_TOL, cfg),
                against=(tok, INT8_VS_BF16_TOL))
            time_attn_q8(tag, tok8)
        # the next model needs the memory: p128 is initialised in fp32
        del tok, tok8
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    try:
        phase_device()
        repo = pathlib.Path(__file__).resolve().parent
        sys.path.insert(0, str(repo))
        try:
            import tae_tpu_torch  # noqa: F401
        except ImportError as e:
            raise SmokeFailure(f"cannot import tae_tpu_torch next to "
                               f"{pathlib.Path(__file__).name}: {e}") from e
        phase_build()
        kres = phase_kernels()
        kres.update(phase_int8_kernels())
        kres.update(phase_attention_kernels())
        launches = phase_paths()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    import torch

    def old_style(cases, main, lib_case):
        """K1/K2 case tuples -> the record of the main-path shape."""
        c = next(c for c in cases if main(c))
        return dict(max_abs_err=max(c[1] for c in cases), ms=c[2],
                    plain_ms=c[3], bound_ms=c[-2][0], bound_by=c[-2][1],
                    library_ms=next(c for c in cases if lib_case(c))[-1])

    def slice_shape(c):
        return c[0] == torch.bfloat16 and c[4] == 256

    records = {
        "fused_layer_norm": old_style(kres["fused_layer_norm"],
                                      lambda c: c[0] == torch.bfloat16,
                                      lambda c: c[0] == torch.bfloat16),
        # the library call has no clamped softmax: its time is the exact form's
        "fused_qkv_attention": old_style(
            kres["fused_qkv_attention"], lambda c: slice_shape(c) and c[5],
            lambda c: slice_shape(c) and not c[5]),
    }
    for name in [k["name"] for k in (K3, K4, K5, K6, K7, K8, K9)]:
        cases = kres[name]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        records[name] = dict({k: cases[0][k] for k in keys},
                             max_abs_err=max(c["max_abs_err"] for c in cases),
                             cases=cases)
    # K6's library call has only the exact softmax: the time at the same shape
    k6 = kres[K6["name"]]
    records[K6["name"]]["library_ms"] = next(
        c["library_ms"] for c in k6 if c["library_ms"] is not None)
    kernels = []
    for meta in (K1, K2, K3, K4, K5, K6, K7, K8, K9):
        by_path = {path: counts[meta["name"]]
                   for path, counts in launches.items()}
        kernels.append(dict(meta, launches=sum(by_path.values()),
                            launches_by_path=by_path, **records[meta["name"]]))
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"FAIL: no path launched {idle}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
