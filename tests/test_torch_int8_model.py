"""The port's int8 (w8a8) serving path vs the JAX package, on the CPU: the
equalization rewrite, the fused int8 block and the chained stack, both
halves of the model, the int8 ``Tokenizer``, and the serving artifact.

The JAX side runs its Pallas kernels in interpret mode and is composed here
exactly as ``blocks_apply`` and ``TAE._blocks_then_head`` compose it on its
own accelerator; the port runs its plain versions. The JAX package's
quantized, unstacked serving tree is carried over with
``serving_state_dict_from_jax``, so both sides hold bit-identical int8
weights. In interpret mode the JAX block takes the exact-softmax attention,
so the port runs ``serving=False`` there (the serving block with its
int8-output attention is held in tests/test_torch_tiny_n_model.py).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.nn import vit as jvit
from tae_tpu.ops.int8 import equalize_params as j_equalize_params
from tae_tpu.ops.int8 import int8_linear as j_int8_linear
from tae_tpu.ops.int8 import prepare_serving_params as j_prepare_serving
from tae_tpu.ops.int8 import quantize_params as j_quantize_params
from tae_tpu.ops.int8 import unstack_blocks as j_unstack_blocks
from tae_tpu.ops.patchify import extract_patches as j_extract_patches
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import (serving_state_dict_from_jax,
                                       state_dict_from_jax)
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.cuda.flash_attention import fused_qkv_attention
from tae_tpu_torch.ops.cuda.int8_block import int8_mlp, ln_quant
from tae_tpu_torch.ops.cuda.int8_matmul import int8_matmul_fused
from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
from tae_tpu_torch.ops.cuda.wide_attention import (
    fused_qkv_attention_q8, fused_qkv_attention_wide,
    fused_qkv_attention_wide_q8, fused_qkv_attention_wide_q8_2d)
from tae_tpu_torch.tokenizer import Tokenizer
from tae_tpu_torch.utils.dtypes import Policy

REPO = pathlib.Path(__file__).resolve().parent.parent
NAME = "tae_patch16_vocab16_px256"
# 16 tokens of width 128, MLP hidden 512, three blocks per half
TINY = dict(img_size=64, embed_dim=128, depth=3, num_heads=4,
            decoder_embed_dim=128, decoder_depth=3, decoder_num_heads=4)
BLOCK_H = int8.DEFAULT_BLOCK_H
# Fused int8 path against fused int8 path, same int8 weights, fp32
# activations: a value within an ulp of a rounding tie can take the
# neighbouring int8 code on one side, and the layers after it see that
# step, so the paths are close but not bit-equal. Mean-abs relative error;
# measured 1.5e-7 to 4e-7 here (no code flipped), the bound leaves room for
# a few flips.
CHAIN_REL = 5e-3
FP32 = Policy(torch.float32, torch.float32)
JFP32 = JPolicy(jnp.float32, jnp.float32)


def _mean_rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).mean() / np.abs(w).mean())


@pytest.fixture(scope="module")
def jax_float():
    jm = jmodels.create(NAME, **TINY)
    params = jm.init(jax.random.key(3))
    # LN affines away from the identity, so the chained epilogues matter
    rng = np.random.default_rng(0)

    def jitter(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias"}:
                s = np.asarray(tree["scale"])
                return {"scale": jnp.asarray(s * rng.uniform(0.7, 1.4, s.shape)
                                             .astype(np.float32)),
                        "bias": jnp.asarray(rng.normal(0, 0.1, s.shape)
                                            .astype(np.float32))}
            return {k: jitter(v) for k, v in tree.items()}
        return tree

    return jm, jitter(params)


@pytest.fixture(scope="module")
def pair(jax_float):
    """(JAX model, its int8 serving tree, the port's model holding the same
    int8 weights)."""
    jm, params = jax_float
    sp = j_prepare_serving(params, "int8")
    tm = models.create(NAME, **TINY)
    int8.quantize_params_(tm, fill=False)
    tm.load_state_dict(serving_state_dict_from_jax(
        jax.tree.map(np.asarray, sp), jm.cfg), strict=True)
    return jm, sp, tm.eval()


@pytest.fixture
def same_block_h(monkeypatch):
    """Pin the JAX side's hidden block to the port's: it is part of the
    numerics, and the JAX planner would pick another."""
    monkeypatch.setenv("TAE_TPU_INT8_MLP_BH", str(BLOCK_H))


def j_chained_stack(layers, x, cfg, final_norm=None):
    """The loop of ``tae_tpu.nn.vit.blocks_apply`` over an unstacked int8
    stack, with the kernels in interpret mode."""
    ln = None
    for i, layer in enumerate(layers):
        nxt = layers[i + 1]["norm1"] if i + 1 < len(layers) else final_norm
        x, ln = jvit.int8_block_apply(layer, x, cfg, interpret=True, ln_in=ln,
                                      norm1_next=nxt, chain=True)
    return x, ln


def j_head(p, x, ln):
    xq, sx = ln
    b, n, _ = x.shape
    return jvit._qlinear(p, xq, x_scale=sx, out_dtype=jnp.float32,
                         interpret=True).reshape(b, n, -1)


def j_forward_encoder(jm, sp, imgs):
    enc, c = sp["encoder"], jm.cfg
    x = jvit.patch_embed_apply(enc["patch_embed"], jnp.asarray(imgs),
                               c.patch_size) + enc["pos_embed"]
    x, ln = j_chained_stack(enc["blocks"], x, c.enc_block, enc["norm"])
    return j_head(enc["dict_proj"], x, ln)


def j_forward_decoder(jm, sp, z):
    dec, c = sp["decoder"], jm.cfg
    e = dec["embed"]
    x = j_int8_linear(jnp.asarray(z), e["w_q"], e["w_scale"], e["b"],
                      interpret=True) + dec["pos_embed"]
    x, ln = j_chained_stack(dec["blocks"], x, c.dec_block, dec["norm"])
    return j_head(dec["pred"], x, ln)


# ------------------------------------------------------------ equalization

@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_equalize_params_exact_in_float_and_equal_to_jax(jax_float, alpha):
    jm, params = jax_float
    # outlier channels, as trained transformers grow them
    g = np.array(params["encoder"]["blocks"]["norm2"]["scale"])
    g[:, ::13] *= 37.0
    params = jax.tree.map(lambda x: x, params)
    params["encoder"]["blocks"]["norm2"]["scale"] = jnp.asarray(g)
    np_params = jax.tree.map(np.asarray, params)

    tm = models.create(NAME, **TINY)
    tm.load_state_dict(state_dict_from_jax(np_params, jm.cfg), strict=True)
    imgs = np.random.default_rng(0).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    _, pred0 = tm(torch.from_numpy(imgs), policy=FP32)
    int8.equalize_params_(tm, alpha)
    _, pred1 = tm(torch.from_numpy(imgs), policy=FP32)
    # exact in real arithmetic: fp32 rounding only, relative to the output
    # magnitude (the bound tests/test_ops.py holds the JAX rewrite to)
    assert float((pred1 - pred0).abs().max()) <= 1e-4 * float(pred0.abs().max())

    want = state_dict_from_jax(
        jax.tree.map(np.asarray, j_equalize_params(params, alpha)), jm.cfg)
    got, before = tm.state_dict(), state_dict_from_jax(np_params, jm.cfg)
    assert set(got) == set(want)
    changed = 0
    for k, v in want.items():
        # leaf by leaf; pow() of the two libraries can differ in the last bit
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        changed += not torch.equal(v, before[k])
    # per block two (norm weight, norm bias, linear weight) triples, and one
    # triple per head; a zero LN bias stays zero
    assert changed >= 2 * 2 * (3 + 3) + 2 * 2


# ---------------------------------------------------- block, stack, halves

def test_int8_weights_carried_over_bit_identical(pair):
    jm, sp, tm = pair
    q = sp["encoder"]["blocks"][1]["attn"]["qkv"]
    lin = tm.blocks[1].attn.qkv
    assert isinstance(lin, vit.QLinear) and lin.w_q.dtype == torch.int8
    assert np.array_equal(lin.w_q.numpy().T, np.asarray(q["w_q"]))
    assert np.array_equal(lin.w_scale.numpy(), np.asarray(q["w_scale"]))
    assert isinstance(tm.patch_embed.proj, vit.PatchProj)    # skipped: float
    n_q = sum(isinstance(m, vit.QLinear) for m in tm.modules())
    assert n_q == 4 * (3 + 3) + 3


def test_port_quantization_equals_jax_quantization(jax_float):
    """Quantizing in the port == the JAX package's ``quantize_params`` of the
    same float weights, code for code and scale for scale. (Run eagerly:
    under ``jit``, as ``prepare_serving_params`` runs it, XLA turns the
    ``/ 127`` into a multiplication by 1/127 and the scales move by an ulp.)"""
    jm, params = jax_float
    sp = j_unstack_blocks(j_quantize_params(params))
    want = serving_state_dict_from_jax(jax.tree.map(np.asarray, sp), jm.cfg)
    tm = models.create(NAME, **TINY)
    tm.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jm.cfg), strict=True)
    int8.prepare_serving_(tm, "int8")
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    # patch_input=True quantizes the patch embedding too
    sp2 = j_unstack_blocks(j_quantize_params(params, skip=()))
    want2 = serving_state_dict_from_jax(jax.tree.map(np.asarray, sp2), jm.cfg)
    tm2 = models.create(NAME, **TINY)
    tm2.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jm.cfg), strict=True)
    int8.prepare_serving_(tm2, "int8", patch_input=True)
    assert torch.equal(tm2.state_dict()["patch_embed.proj.w_q"],
                       want2["patch_embed.proj.w_q"])
    with pytest.raises(ValueError, match="unknown quantization"):
        int8.prepare_serving_(tm2, "int3")


@pytest.mark.parametrize("chained", [False, True])
def test_int8_block_matches_jax(pair, same_block_h, chained):
    """One block, with and without a next LayerNorm in its MLP epilogue."""
    jm, sp, tm = pair
    x = np.random.default_rng(13).standard_normal((2, 16, 128)).astype(np.float32)
    layers = sp["encoder"]["blocks"]
    nxt = layers[1]["norm1"] if chained else None
    want, ln_j = jvit.int8_block_apply(layers[0], jnp.asarray(x),
                                       jm.cfg.enc_block, interpret=True,
                                       norm1_next=nxt, chain=True)
    got, ln = tm.blocks[0].forward_int8(
        torch.from_numpy(x), norm1_next=tm.blocks[1].norm1 if chained else None)
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel
    assert (ln is None) == (ln_j is None) == (not chained)
    if chained:
        diff = np.abs(ln[0].numpy().astype(np.int32)
                      - np.asarray(ln_j[0], np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(ln[1].numpy(), np.asarray(ln_j[1]),
                                   rtol=1e-5)
    # Block.forward takes the same path
    assert torch.equal(tm.blocks[0](torch.from_numpy(x)), got) or chained


def test_chained_int8_stack_matches_jax(pair, same_block_h):
    jm, sp, tm = pair
    x = np.random.default_rng(50).standard_normal((2, 16, 128)).astype(np.float32)
    want, ln_j = j_chained_stack(sp["encoder"]["blocks"], jnp.asarray(x),
                                 jm.cfg.enc_block)
    assert ln_j is None         # the last layer has no successor to chain into
    got = vit.blocks_apply(tm.blocks, torch.from_numpy(x))
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel
    # with the final norm chained in, the head's quantized input comes out
    want, ln_j = j_chained_stack(sp["encoder"]["blocks"], jnp.asarray(x),
                                 jm.cfg.enc_block, sp["encoder"]["norm"])
    got, ln = vit.blocks_apply(tm.blocks, torch.from_numpy(x),
                               final_norm=tm.norm)
    assert _mean_rel(got, want) <= CHAIN_REL
    assert _mean_rel(ln[0].float() * ln[1],
                     np.asarray(ln_j[0], np.float32) * np.asarray(ln_j[1])) \
        <= CHAIN_REL


def test_int8_halves_match_jax_composition(pair, same_block_h):
    """The slice as a whole: patch embed, position add, chained blocks,
    final-norm chain and head, per half."""
    jm, sp, tm = pair
    rng = np.random.default_rng(21)
    imgs = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    z_j = j_forward_encoder(jm, sp, imgs)
    z = tm.forward_encoder(torch.from_numpy(imgs), policy=FP32)
    assert tuple(z.shape) == (2, 16, 16) and z.dtype == torch.float32
    rel = _mean_rel(z, z_j)
    assert rel <= CHAIN_REL, rel
    zin = np.asarray(z_j)
    rec_j = j_forward_decoder(jm, sp, zin)
    rec = tm.forward_decoder(torch.from_numpy(zin), policy=FP32)
    assert tuple(rec.shape) == (2, 16, 768)
    rel = _mean_rel(rec, rec_j)
    assert rel <= CHAIN_REL, rel
    # pre-patchified rows take the same path
    rows = np.asarray(j_extract_patches(jnp.asarray(imgs), 16))
    assert torch.equal(tm.forward_encoder(torch.from_numpy(rows), policy=FP32), z)


def test_mixed_stack_chains_only_between_int8_blocks(pair):
    """A float block in the middle: the block before it does not chain, the
    block after it quantizes its own input; the result equals running the
    blocks one by one."""
    jm, sp, tm = pair
    stack = torch.nn.ModuleList([tm.blocks[0],
                                 vit.Block(vit.BlockConfig(128, 4)),
                                 tm.blocks[2]])
    gen = torch.Generator().manual_seed(0)
    vit.init_weights_(stack[1], gen)
    x = torch.randn((1, 16, 128), generator=gen)
    got, ln = vit.blocks_apply(stack, x, final_norm=tm.norm)
    want = x
    for blk in stack:
        want = blk(want)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert ln is not None and ln[0].dtype == torch.int8
    assert not stack[1].is_int8 and stack[0].is_int8


# ---------------------------------------------------------------- tokenizer

@pytest.fixture(scope="module")
def int8_tokenizers(tmp_path_factory):
    """The JAX int8 Tokenizer and the port's, from the same float weights
    (the JAX Tokenizer's own seeded init, carried over as a ``.pth``)."""
    jtok = JTokenizer.from_checkpoint(NAME, dtype=jnp.float32,
                                      quantization="int8", **TINY)
    jm = jtok.model
    params = jax.jit(lambda k: jm.init(k, dtype=jnp.float32))(jax.random.key(0))
    path = tmp_path_factory.mktemp("ckpt") / "float.pth"
    torch.save(state_dict_from_jax(jax.tree.map(np.asarray, params), jm.cfg),
               path)
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                    device="cpu", quantization="int8", **TINY)
    return jtok, tok, path


def test_int8_tokenizer_matches_jax_int8_tokenizer(int8_tokenizers):
    """On the CPU the JAX Tokenizer takes its unfused int8 path with one
    hidden scale per row, a different but equally valid quantization of the
    same weights: the bound is the loose one its own tests use, and catches
    a wiring fault on either side."""
    jtok, tok, _ = int8_tokenizers
    q = jtok.params["encoder"]["blocks"][0]["mlp"]["fc1"]
    fc1 = tok.model.blocks[0].mlp.fc1
    # the JAX side quantized under jit (scales one ulp apart, see above)
    np.testing.assert_allclose(fc1.w_scale.numpy(), np.asarray(q["w_scale"]),
                               rtol=1e-6)
    diff = np.abs(fc1.w_q.numpy().T.astype(np.int32)
                  - np.asarray(q["w_q"], np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    x = np.random.default_rng(11).integers(0, 256, (2, 3, 64, 64),
                                           dtype=np.uint8)
    z_j, z = np.asarray(jtok.encode(x)), tok.encode(x)
    assert tuple(z.shape) == (2, 16, 16) and z.dtype == torch.float32
    rel = float(np.linalg.norm(z.numpy() - z_j) / np.linalg.norm(z_j))
    assert rel < 0.05, rel
    rec_j, rec = np.asarray(jtok.decode(z_j)), tok.decode(z_j)
    assert tuple(rec.shape) == (2, 3, 64, 64)
    rel = float(np.linalg.norm(rec.numpy() - rec_j) / np.linalg.norm(rec_j))
    assert rel < 0.05, rel


def test_int8_tokenizer_close_to_float_tokenizer(int8_tokenizers):
    _, tok, path = int8_tokenizers
    ftok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                     device="cpu", **TINY)
    x = np.random.default_rng(12).integers(0, 256, (2, 3, 64, 64),
                                           dtype=np.uint8)
    z, zf = tok.encode(x), ftok.encode(x)
    assert float((z - zf).norm() / zf.norm()) < 0.05
    # equalize= changes the weights, not what they compute
    etok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                     device="cpu", quantization="int8",
                                     equalize=True, **TINY)
    assert float((etok.encode(x) - zf).norm() / zf.norm()) < 0.05
    with pytest.raises(ValueError, match="equalize"):
        Tokenizer.from_checkpoint(NAME, device="cpu", equalize=True, **TINY)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_artifact_round_trip(int8_tokenizers, tmp_path, dtype):
    _, _, ckpt = int8_tokenizers
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(ckpt), dtype=dtype,
                                    device="cpu", quantization="int8", **TINY)
    path = tmp_path / "tok.int8.pt"
    tok.save_serving(path)
    blob = torch.load(path, weights_only=True)
    assert blob["serving"] is True and blob["mlp_block_h"] == BLOCK_H
    assert blob["compute_dtype"] == str(dtype)
    assert blob["model"]["blocks.0.attn.qkv.w_q"].dtype == torch.int8
    back = Tokenizer.from_serving(NAME, path, device="cpu", **TINY)
    assert back.policy.compute_dtype == dtype
    x = np.random.default_rng(13).integers(0, 256, (2, 3, 64, 64),
                                           dtype=np.uint8)
    z = tok.encode(x)
    assert torch.equal(back.encode(x), z)                 # bit-identical
    assert torch.equal(back.decode(z), tok.decode(z))
    # pruned on load, and a pruned artifact
    enc = Tokenizer.from_serving(NAME, path, device="cpu", component="encoder",
                                 **TINY)
    assert torch.equal(enc.encode(x), z)
    with pytest.raises(ValueError, match="decoder was pruned"):
        enc.decode(z)
    enc.save_serving(tmp_path / "enc.pt")
    enc2 = Tokenizer.from_serving(NAME, tmp_path / "enc.pt", device="cpu",
                                  **TINY)
    assert torch.equal(enc2.encode(x), z) and not enc2.model.has_decoder
    with pytest.raises(ValueError, match="holds only the encoder"):
        Tokenizer.from_serving(NAME, tmp_path / "enc.pt", device="cpu",
                               component="decoder", **TINY)


def test_from_serving_refuses_a_float_checkpoint(int8_tokenizers):
    _, _, ckpt = int8_tokenizers
    with pytest.raises(ValueError, match="not a serving artifact"):
        Tokenizer.from_serving(NAME, ckpt, device="cpu", **TINY)


def test_bf16_artifact_is_a_serving_artifact_too(tmp_path):
    tok = Tokenizer.from_checkpoint(NAME, device="cpu", **TINY)
    tok.save_serving(tmp_path / "bf16.pt")
    back = Tokenizer.from_serving(NAME, tmp_path / "bf16.pt", device="cpu",
                                  **TINY)
    x = np.random.default_rng(14).integers(0, 256, (1, 3, 64, 64),
                                           dtype=np.uint8)
    assert torch.equal(back.encode(x), tok.encode(x))


def test_unported_quantization_modes_raise():
    with pytest.raises(NotImplementedError, match="A10"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int4",
                                  **TINY)
    with pytest.raises(NotImplementedError, match="calibrate"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                  equalize=True, act_amax={}, **TINY)
    with pytest.raises(NotImplementedError, match="calibrate"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                  equalize=True, calib_images=[], **TINY)
    with pytest.raises(ValueError, match="unknown quantization"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="fp8",
                                  **TINY)
    with pytest.raises(ValueError, match="block_h"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                  **dict(TINY, embed_dim=96))


def test_cpu_int8_serving_leaves_launch_counters_at_zero(int8_tokenizers):
    _, tok, _ = int8_tokenizers
    x = np.random.default_rng(15).integers(0, 256, (1, 3, 64, 64),
                                           dtype=np.uint8)
    tok.reconstruct(x)
    for fn in (ln_quant, int8_matmul_fused, int8_mlp, fused_qkv_attention,
               fused_layer_norm, fused_qkv_attention_wide,
               fused_qkv_attention_q8, fused_qkv_attention_wide_q8,
               fused_qkv_attention_wide_q8_2d):
        assert fn.launches == 0, fn.__name__


# ------------------------------------------------------ isolation, packaging

def test_importing_every_port_module_leaves_jax_out():
    """Run in a fresh interpreter: this process has imported jax itself."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tae_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tae_tpu_torch.__path__, 'tae_tpu_torch.')]\n"
        "assert len(names) > 20, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'tae_tpu', 'triton')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) > 20


def test_no_jax_import_in_the_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|tae_tpu)\b", re.M)
    files = list((REPO / "tae_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def test_every_kernel_source_is_packaged():
    """Each file of csrc/ is matched by pyproject.toml's package-data globs
    (a wheel without them could not build its kernels)."""
    import fnmatch
    import tomllib

    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["tae_tpu_torch"]
    csrc = REPO / "tae_tpu_torch" / "csrc"
    names = sorted(p.name for p in csrc.iterdir())
    assert {"int8_block.cu", "int8_matmul.cu", "int8_common.cuh",
            "wide_attention.cu"} <= set(names)
    for name in names:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name
    assert "tae_tpu_torch*" in \
        data["tool"]["setuptools"]["packages"]["find"]["include"]
