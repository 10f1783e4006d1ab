"""Port ops vs the JAX package: patchify, LayerNorm, packed attention, device
normalize — and the port's isolation and no-fallback rules.

Inputs are made with numpy from a seed and fed to both packages. The JAX
Pallas kernels run in interpret mode, as tests/test_ops.py runs them; the
port runs its plain versions (the kernel wrappers take them for CPU tensors).
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.data.transforms import device_normalize as j_device_normalize
from tae_tpu.data.transforms import (
    device_normalize_patches as j_device_normalize_patches)
from tae_tpu.ops.patchify import extract_patches as j_extract_patches
from tae_tpu.ops.patchify import patchify as j_patchify
from tae_tpu.ops.patchify import unpatchify as j_unpatchify
from tae_tpu.ops.attention import attention_xla
from tae_tpu.ops.layernorm import layer_norm_xla
from tae_tpu.ops.pallas.flash_attention import fused_qkv_attention as j_fqa
from tae_tpu.ops.pallas.layernorm import fused_layer_norm as j_fln
from tae_tpu_torch.data import transforms as ttransforms
from tae_tpu_torch.ops import patchify as tpatch
from tae_tpu_torch.ops.attention import attention_reference, default_backend
from tae_tpu_torch.ops.cuda import build
from tae_tpu_torch.ops.cuda.flash_attention import (
    fused_qkv_attention, fused_qkv_attention_reference)
from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
from tae_tpu_torch.ops.layernorm import layer_norm, layer_norm_reference

REPO = pathlib.Path(__file__).resolve().parent.parent
# One bf16 ulp is between 2^-8 and 2^-7 of the value: where both sides
# compute in fp32 and round once, a last-bit difference in fp32 can flip one
# rounding, so bf16 outputs agree to rtol 2^-7 (plus a tiny atol for zeros).
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- patchify

@pytest.mark.parametrize("fn", ["extract_patches", "patchify"])
def test_patch_layouts_exact(fn):
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    got = getattr(tpatch, fn)(torch.from_numpy(x), 8)
    jfn = {"extract_patches": j_extract_patches, "patchify": j_patchify}[fn]
    want = jfn(jnp.asarray(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpatchify_exact_and_inverse():
    x = np.random.default_rng(1).standard_normal((2, 16, 8 * 8 * 3)).astype(np.float32)
    got = tpatch.unpatchify(torch.from_numpy(x), 8, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_unpatchify(jnp.asarray(x), 8, 3)))
    np.testing.assert_array_equal(tpatch.patchify(got, 8).numpy(), x)
    with pytest.raises(ValueError, match="square"):
        tpatch.unpatchify(torch.zeros(1, 15, 192), 8)


# --------------------------------------------------------------- layernorm

def _ln_inputs(shape, seed=9):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", [(4, 7, 256), (100, 1024)])
def test_layer_norm_fp32_matches_jax(shape):
    x, w, b = _ln_inputs(shape)
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    ref = layer_norm_xla(jx, jw, jb, 1e-6)
    # fp32 sums over D taken in another order: the JAX kernel's own test
    # bound (tests/test_ops.py test_fused_layer_norm_matches_xla)
    _close(j_fln(jx, jw, jb, 1e-6, True), ref, 1e-5, 1e-5)
    _close(layer_norm_reference(tx, tw, tb, 1e-6), ref, 1e-5, 1e-5)
    _close(fused_layer_norm(tx, tw, tb, 1e-6), ref, 1e-5, 1e-5)
    _close(layer_norm(tx, tw, tb, 1e-6), ref, 1e-5, 1e-5)


def test_layer_norm_bf16_matches_jax_kernel():
    x, w, b = _ln_inputs((64, 512), seed=3)
    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    want = j_fln(jx, jw, jb, 1e-6, True)
    got = fused_layer_norm(tx, tw, tb, 1e-6)
    assert got.dtype == torch.bfloat16
    _close(got, want, **BF16_ULP)
    _close(layer_norm_reference(tx, tw, tb), layer_norm_xla(jx, jw, jb), **BF16_ULP)


# --------------------------------------------------------------- attention

ATTN_SHAPES = [(16, 2, 64), (8, 3, 80), (5, 2, 80)]


def _qkv(n, h, dh, seed=5, q_scale=1.0):
    c = h * dh
    qkv = np.random.default_rng(seed).standard_normal((2, n, 3 * c)).astype(np.float32)
    qkv[:, :, :c] *= q_scale
    return qkv


def _split_reference(qkv, h):
    b, n, c3 = qkv.shape
    c = c3 // 3
    r = qkv.reshape(b, n, 3, h, c // h).transpose(2, 0, 3, 1, 4)
    return attention_xla(r[0], r[1], r[2]).transpose(0, 2, 1, 3).reshape(b, n, c)


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("n,h,dh", ATTN_SHAPES)
def test_packed_attention_fp32_matches_jax(n, h, dh, serving):
    qkv = _qkv(n, h, dh)
    jq, tq = jnp.asarray(qkv), torch.from_numpy(qkv)
    want = j_fqa(jq, h, interpret=True, serving=serving)
    # scores stay inside the serving clamp here, so both forms equal the
    # XLA reference; fp32 bound of tests/test_ops.py for the JAX kernel
    _close(want, _split_reference(jq, h), 2e-5, 2e-5)
    _close(fused_qkv_attention_reference(tq, h, serving=serving), want, 2e-5, 2e-5)
    _close(fused_qkv_attention(tq, h, serving=serving), want, 2e-5, 2e-5)


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("n,h,dh", ATTN_SHAPES[:2])
def test_packed_attention_bf16_matches_jax(n, h, dh, serving):
    qkv = _qkv(n, h, dh, seed=6)
    want = j_fqa(jnp.asarray(qkv, jnp.bfloat16), h, interpret=True,
                 serving=serving)
    got = fused_qkv_attention(torch.from_numpy(qkv).to(torch.bfloat16), h,
                              serving=serving)
    assert got.dtype == torch.bfloat16
    # p is rounded to bf16 before P·V on both sides; an fp32 last-bit
    # difference in exp can flip one p rounding (2^-8 of one term of a
    # normalised sum), then the output rounds once to bf16: one ulp plus
    # that, i.e. 1e-2 relative at |o| ~ 1 with an atol for small outputs
    _close(got, want, 4e-3, 1e-2)


def test_packed_attention_serving_clamp_matches_jax():
    """Scores far outside [-60, 45]: the clamped serving form diverges from
    the exact one, and the port diverges exactly as the JAX kernel does."""
    n, h, dh = 32, 2, 64
    qkv = _qkv(n, h, dh, seed=1, q_scale=30.0)
    jq, tq = jnp.asarray(qkv), torch.from_numpy(qkv)
    exact = j_fqa(jq, h, interpret=True, serving=False)
    serving = j_fqa(jq, h, interpret=True, serving=True)
    assert np.abs(_np(serving) - _np(exact)).max() > 1e-3
    _close(fused_qkv_attention_reference(tq, h, serving=False), exact, 2e-5, 1e-5)
    _close(fused_qkv_attention_reference(tq, h, serving=True), serving, 2e-5, 1e-5)


def test_attention_reference_matches_xla():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
               for _ in range(3))
    want = attention_xla(*map(jnp.asarray, (q, k, v)))
    _close(attention_reference(*map(torch.from_numpy, (q, k, v))), want, 2e-5, 2e-5)


# -------------------------------------------------------- device normalize

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_normalize_matches_jax(dtype):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 3, 16, 16), dtype=np.uint8)
    rows = rng.integers(0, 256, (2, 4, 3 * 8 * 8), dtype=np.uint8)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # same constants rounded to the same dtype, same two ops: fp32 agrees
    # to rounding, bf16 to one ulp
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else BF16_ULP
    got = ttransforms.maybe_device_normalize(torch.from_numpy(imgs), 8, td)
    assert got.dtype == td
    _close(got, j_device_normalize(jnp.asarray(imgs), jd), **tol)
    got = ttransforms.maybe_device_normalize(torch.from_numpy(rows), 8, td)
    _close(got, j_device_normalize_patches(jnp.asarray(rows), 8, jd), **tol)
    x = torch.zeros(1, 3, 4, 4)
    assert ttransforms.maybe_device_normalize(x, 8, td) is x


# ------------------------------------------------- isolation, no fallback

def test_import_leaves_jax_and_triton_out():
    code = (
        "import sys\n"
        "import tae_tpu_torch, tae_tpu_torch.tokenizer, tae_tpu_torch.models\n"
        "import tae_tpu_torch.ckpt.bridge, tae_tpu_torch.data.transforms\n"
        "import tae_tpu_torch.ops.cuda.layernorm, tae_tpu_torch.ops.cuda.flash_attention\n"
        "import tae_tpu_torch.ops.int8, tae_tpu_torch.ops.cuda.int8_block\n"
        "import tae_tpu_torch.ops.cuda.int8_matmul, tae_tpu_torch.profile_serving\n"
        "import tae_tpu_torch.train, tae_tpu_torch.ckpt.io\n"
        "import tae_tpu_torch.ckpt.interpolate, tae_tpu_torch.profile_training\n"
        "import tae_tpu_torch.ops.cuda.wide_attention\n"
        "bad = [m for m in ('jax', 'triton', 'tae_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_library(build_root=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_wrappers_refuse_non_cpu_tensors_without_fallback():
    x = torch.empty(4, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_layer_norm(x, w, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_qkv_attention(torch.empty(1, 4, 3 * 128, device="meta"), 2)
    assert default_backend(torch.zeros(1)) == "reference"
    with pytest.raises(ValueError, match="unknown backend"):
        layer_norm(torch.zeros(2, 8), torch.ones(8), torch.zeros(8),
                   backend="pallas")


def test_cpu_path_leaves_launch_counters_at_zero():
    before = (fused_layer_norm.launches, fused_qkv_attention.launches)
    fused_layer_norm(*map(torch.from_numpy, _ln_inputs((3, 64))))
    fused_qkv_attention(torch.from_numpy(_qkv(4, 2, 64)), 2)
    layer_norm(torch.zeros(2, 8), torch.ones(8), torch.zeros(8),
               backend="kernel")
    assert (fused_layer_norm.launches, fused_qkv_attention.launches) == before == (0, 0)
