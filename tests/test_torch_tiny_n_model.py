"""The port's tiny-N serving paths (4, 16 and 64 tokens per image) vs the JAX
package, on the CPU: the fused int8 block and chained stack with the
int8-output attention entries, and the tiny-N ``Tokenizer`` in bf16 and
int8.

On its accelerator the JAX int8 block takes ``fused_qkv_attention_wide_q8``
(``_2d`` below 8 tokens) and hands its ``(y, y_scale)`` to the proj matmul;
in interpret mode ``int8_block_apply`` itself takes XLA's attention instead.
So the JAX side is composed here from the package's own functions in the
order the block runs them on the accelerator, every Pallas kernel with
``interpret=True``; the port runs ``Block.forward_int8(serving=True)``
through its plain versions. Both sides hold bit-identical int8 weights
(``serving_state_dict_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.nn import vit as jvit
from tae_tpu.ops.int8 import int8_linear as j_int8_linear
from tae_tpu.ops.int8 import prepare_serving_params as j_prepare_serving
from tae_tpu.ops.pallas import flash_attention as jfa
from tae_tpu.ops.pallas.int8_block import ln_quant as j_ln_quant
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import (serving_state_dict_from_jax,
                                       state_dict_from_jax)
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.attention import ROUTES, attention_route
from tae_tpu_torch.ops.cuda.int8_block import int8_mlp, ln_quant
from tae_tpu_torch.ops.cuda.int8_matmul import int8_matmul_fused
from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
from tae_tpu_torch.tokenizer import Tokenizer, set_attn_q8

NAME = "tae_patch16_vocab16_px256"
# width 128, MLP hidden 512, three blocks per half; img_size 32 gives 4
# tokens of 16 x 16 pixels, 64 gives 16
TINY = dict(embed_dim=128, depth=3, num_heads=4, decoder_embed_dim=128,
            decoder_depth=3, decoder_num_heads=4)
IMG = {4: 32, 16: 64}
BLOCK_H = int8.DEFAULT_BLOCK_H
# Fused int8 path against fused int8 path, same int8 weights, fp32
# activations, the serving softmax on both sides: a value within an ulp of
# a rounding tie can take the neighbouring int8 code on one side (the
# attention output's codes included, now that they come from the kernel's
# epilogue), and the layers after it see that step, so the paths are close
# but not bit-equal. Mean-abs relative error; the bound of
# tests/test_torch_int8_model.py, which leaves room for a few flips
# (measured here: 5e-8 to 1e-7 where no code flipped, 1.1e-3 on the
# three-block stack at 4 tokens, where one did).
CHAIN_REL = 5e-3


def _mean_rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).mean() / np.abs(w).mean())


@pytest.fixture(scope="module", params=[4, 16], ids=["n4", "n16"])
def pair(request):
    """(tokens, JAX model, its int8 serving tree, the port's model holding
    the same int8 weights), LN affines away from the identity."""
    n = request.param
    jm = jmodels.create(NAME, img_size=IMG[n], **TINY)
    params = jm.init(jax.random.key(5))
    rng = np.random.default_rng(1)

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

    sp = j_prepare_serving(jitter(params), "int8")
    tm = models.create(NAME, img_size=IMG[n], **TINY)
    int8.quantize_params_(tm, fill=False)
    tm.load_state_dict(serving_state_dict_from_jax(
        jax.tree.map(np.asarray, sp), jm.cfg), strict=True)
    return n, jm, sp, tm.eval()


@pytest.fixture
def same_block_h(monkeypatch):
    """Pin the JAX side's hidden block to the port's: it is part of the
    numerics, and the JAX planner would pick another."""
    monkeypatch.setenv("TAE_TPU_INT8_MLP_BH", str(BLOCK_H))


def j_block_on_accelerator(layer, x, cfg, ln_in=None, norm1_next=None):
    """``tae_tpu.nn.vit.int8_block_apply`` below 128 tokens as it runs on its
    accelerator (``:313-319``, ``:355``, ``:403-408``, ``:424-436``), every
    kernel in interpret mode: ln_quant -> qkv matmul -> wide int8-output
    attention (flat rows below 8 tokens) -> proj matmul reading
    ``(y, y_scale)`` with the residual and the norm2 chain -> fused MLP."""
    b, n, c = x.shape
    h = cfg.num_heads
    x2 = x.reshape(b * n, c)
    if ln_in is not None:
        xq, sx = ln_in
    else:
        xq, sx = j_ln_quant(x2, layer["norm1"]["scale"], layer["norm1"]["bias"],
                            cfg.ln_eps, interpret=True)
    a = layer["attn"]
    qkv = jvit._qlinear(a["qkv"], xq, x_scale=sx, out_dtype=x.dtype,
                        interpret=True)
    if n < 8:
        y, y_scale = jfa.fused_qkv_attention_wide_q8_2d(qkv, n, h,
                                                        interpret=True)
    else:
        yq, sy = jfa.fused_qkv_attention_wide_q8(qkv.reshape(b, n, 3 * c), h,
                                                 interpret=True)
        y, y_scale = yq.reshape(b * n, c), sy.reshape(b * n, 1)
    x2, xq2, sx2 = j_int8_linear(
        y, a["proj"]["w_q"], a["proj"]["w_scale"], a["proj"].get("b"),
        x_scale=y_scale, residual=x2, out_dtype=x.dtype, backend="pallas",
        interpret=True,
        ln_out=(layer["norm2"]["scale"], layer["norm2"]["bias"], cfg.ln_eps))
    ln2 = (xq2, sx2) if xq2 is not None else None
    out, ln_next = jvit._int8_mlp_half(layer, x2, cfg, True, ln2=ln2,
                                       norm1_next=norm1_next)
    return out.reshape(b, n, c), ln_next


def j_stack_on_accelerator(layers, x, cfg, final_norm=None):
    ln = None
    for i, layer in enumerate(layers):
        nxt = layers[i + 1]["norm1"] if i + 1 < len(layers) else final_norm
        x, ln = j_block_on_accelerator(layer, x, cfg, ln_in=ln, norm1_next=nxt)
    return x, ln


# ------------------------------------------------------------ block and stack

@pytest.mark.parametrize("chained", [False, True])
def test_tiny_n_int8_block_matches_jax_composition(pair, same_block_h, chained):
    """One serving block, with and without a next LayerNorm in its MLP
    epilogue; the attention output reaches proj as int8 codes and scales."""
    n, jm, sp, tm = pair
    x = np.random.default_rng(13).standard_normal((5, n, 128)).astype(np.float32)
    layers = sp["encoder"]["blocks"]
    want, ln_j = j_block_on_accelerator(
        layers[0], jnp.asarray(x), jm.cfg.enc_block,
        norm1_next=layers[1]["norm1"] if chained else None)
    got, ln = tm.blocks[0].forward_int8(
        torch.from_numpy(x), serving=True,
        norm1_next=tm.blocks[1].norm1 if chained else None)
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel
    assert (ln is None) == (ln_j is None) == (not chained)
    if chained:
        diff = np.abs(ln[0].numpy().astype(np.int32)
                      - np.asarray(ln_j[0], np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(ln[1].numpy(), np.asarray(ln_j[1]),
                                   rtol=1e-5)
    else:
        # Block.forward with serving=True takes the same path
        assert torch.equal(tm.blocks[0](torch.from_numpy(x), serving=True), got)


def test_tiny_n_chained_int8_stack_matches_jax_composition(pair, same_block_h):
    n, jm, sp, tm = pair
    x = np.random.default_rng(50).standard_normal((3, n, 128)).astype(np.float32)
    want, ln_j = j_stack_on_accelerator(sp["encoder"]["blocks"], jnp.asarray(x),
                                        jm.cfg.enc_block, sp["encoder"]["norm"])
    got, ln = vit.blocks_apply(tm.blocks, torch.from_numpy(x), serving=True,
                               final_norm=tm.norm)
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel
    assert _mean_rel(ln[0].float() * ln[1],
                     np.asarray(ln_j[0], np.float32) * np.asarray(ln_j[1])) \
        <= CHAIN_REL


def test_serving_int8_block_hands_proj_the_attention_codes(pair, monkeypatch):
    """With the rule, no per-row quantize runs between attention and proj:
    proj receives int8 rows and their scales from the attention entry. With
    attn_q8=False, or outside serving, it receives a float y and quantizes
    it itself."""
    n, _, _, tm = pair
    blk = tm.blocks[0]
    seen = []
    real = int8.int8_linear

    def spy(x, *args, **kw):
        seen.append((x.dtype, kw.get("x_scale") is not None))
        return real(x, *args, **kw)

    monkeypatch.setattr(int8, "int8_linear", spy)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, n, 128)).astype(np.float32))
    route = "wide_q8_2d" if n < 8 else "wide_q8"
    assert attention_route(n, True, True, blk.attn.attn_q8) == (route, True)
    with_codes = blk.forward_int8(x, serving=True)[0]
    assert seen == [(torch.int8, True), (torch.int8, True)]     # qkv, proj
    seen.clear()
    set_attn_q8(tm, False)
    try:
        with_float = blk.forward_int8(x, serving=True)[0]
    finally:
        set_attn_q8(tm, None)
    assert seen == [(torch.int8, True), (torch.float32, False)]
    seen.clear()
    blk.forward_int8(x, serving=False)
    assert seen == [(torch.int8, True), (torch.float32, False)]
    # in fp32 the two routes quantize the same values: close, rarely equal
    assert _mean_rel(with_codes, with_float.numpy()) <= CHAIN_REL


def test_tiny_n_int8_encoder_matches_jax_composition(pair, same_block_h):
    """The encoder half as a whole at 4 and 16 tokens: patch embed, position
    add, chained blocks, final-norm chain and head."""
    n, jm, sp, tm = pair
    imgs = np.random.default_rng(21).standard_normal(
        (3, 3, IMG[n], IMG[n])).astype(np.float32)
    enc, c = sp["encoder"], jm.cfg
    x = jvit.patch_embed_apply(enc["patch_embed"], jnp.asarray(imgs),
                               c.patch_size) + enc["pos_embed"]
    x, (xq, sx) = j_stack_on_accelerator(enc["blocks"], x, c.enc_block,
                                         enc["norm"])
    want = jvit._qlinear(enc["dict_proj"], xq, x_scale=sx,
                         out_dtype=jnp.float32,
                         interpret=True).reshape(3, n, -1)
    from tae_tpu_torch.utils.dtypes import Policy

    got = tm.forward_encoder(torch.from_numpy(imgs),
                             policy=Policy(torch.float32, torch.float32),
                             serving=True)
    assert tuple(got.shape) == (3, n, 16)
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel


# ---------------------------------------------------------------- tokenizer

# the three tiny-N families of the registry, cut to width 128 and two blocks
# per half: 4, 16 and 64 tokens per 256 x 256 image
TOKENIZERS = {"tae_patch128_vocab1024_px256": 4,
              "tae_patch64_vocab256_px256": 16,
              "tae_patch32_vocab64_px256": 64}
SMALL = dict(embed_dim=128, depth=2, num_heads=2, decoder_embed_dim=128,
             decoder_depth=2, decoder_num_heads=2)
# int8 against the float tokenizer on the same weights, relative Frobenius
# error: w8a8 quantization noise through two blocks per half (the bound of
# tests/test_torch_int8_model.py and of the JAX package's own int8 tests)
INT8_VS_FLOAT = 0.05
KERNEL_WRAPPERS = [fn for fn, _ in ROUTES.values()] + [
    ln_quant, int8_matmul_fused, int8_mlp, fused_layer_norm]


@pytest.fixture(scope="module", params=sorted(TOKENIZERS))
def tiny_tok(request, tmp_path_factory):
    """(name, tokens, float checkpoint, float tokenizer, images)."""
    name = request.param
    ftok = Tokenizer.from_checkpoint(name, dtype=torch.float32, device="cpu",
                                     seed=3, **SMALL)
    path = tmp_path_factory.mktemp("ckpt") / "float.pth"
    torch.save(ftok.model.state_dict(), path)
    x = np.random.default_rng(12).integers(0, 256, (2, 3, 256, 256),
                                           dtype=np.uint8)
    return name, TOKENIZERS[name], str(path), ftok, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_n_float_tokenizer_shapes_and_route(tiny_tok, dtype):
    name, n, path, ftok, x = tiny_tok
    tok = Tokenizer.from_checkpoint(name, ckpt=path, dtype=dtype, device="cpu",
                                    **SMALL)
    z = tok.encode(x)
    vocab = tok.model.cfg.vocab_size
    assert tuple(z.shape) == (2, n, vocab) and z.dtype == dtype
    rec = tok.decode(z)
    assert tuple(rec.shape) == (2, 3, 256, 256)
    assert torch.isfinite(z).all() and torch.isfinite(rec).all()
    # bf16 against fp32 on the same weights: bf16 rounding through two
    # blocks per half, relative Frobenius error
    assert float((z.float() - ftok.encode(x)).norm()
                 / ftok.encode(x).norm()) <= (0.0 if dtype == torch.float32
                                              else 3e-2)
    assert attention_route(n, False, True) == (
        "wide" if n <= 8 else "packed", False)


@pytest.mark.parametrize("attn_q8", [None, True, False])
def test_tiny_n_int8_tokenizer_close_to_float(tiny_tok, attn_q8):
    name, n, path, ftok, x = tiny_tok
    tok = Tokenizer.from_checkpoint(name, ckpt=path, dtype=torch.float32,
                                    device="cpu", quantization="int8",
                                    attn_q8=attn_q8, **SMALL)
    assert all(m.attn_q8 is attn_q8 for m in tok.model.modules()
               if isinstance(m, vit.Attention))
    z, zf = tok.encode(x), ftok.encode(x)
    assert tuple(z.shape) == tuple(zf.shape) and torch.isfinite(z).all()
    rel = float((z - zf).norm() / zf.norm())
    assert rel <= INT8_VS_FLOAT, rel
    rec, recf = tok.decode(zf), ftok.decode(zf)
    assert tuple(rec.shape) == (2, 3, 256, 256) and torch.isfinite(rec).all()
    rel = float((rec - recf).norm() / recf.norm())
    assert rel <= INT8_VS_FLOAT, rel
    for fn in KERNEL_WRAPPERS:
        assert fn.launches == 0, fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_n_serving_artifact_round_trip(tiny_tok, tmp_path, dtype):
    """``attn_q8`` is a run-time argument: the artifact does not record it,
    and either setting can be asked for on load."""
    name, n, path, _, x = tiny_tok
    tok = Tokenizer.from_checkpoint(name, ckpt=path, dtype=dtype, device="cpu",
                                    quantization="int8", attn_q8=False, **SMALL)
    art = tmp_path / "tok.int8.pt"
    tok.save_serving(art)
    blob = torch.load(art, weights_only=True)
    assert "attn_q8" not in blob and blob["mlp_block_h"] == BLOCK_H
    same = Tokenizer.from_serving(name, art, device="cpu", attn_q8=False,
                                  **SMALL)
    assert torch.equal(same.encode(x), tok.encode(x))          # bit-identical
    ruled = Tokenizer.from_serving(name, art, device="cpu", **SMALL)
    assert all(m.attn_q8 is None for m in ruled.model.modules()
               if isinstance(m, vit.Attention))
    by_rule = Tokenizer.from_checkpoint(name, ckpt=path, dtype=dtype,
                                        device="cpu", quantization="int8",
                                        **SMALL)
    z = by_rule.encode(x)
    assert torch.equal(ruled.encode(x), z)
    assert torch.equal(ruled.decode(z), by_rule.decode(z))


def test_tiny_n_int8_tokenizer_matches_jax_int8_tokenizer():
    """4 tokens per image against the JAX int8 ``Tokenizer`` on the CPU,
    which takes its unfused int8 path there (XLA's exact attention, one
    hidden scale per row): a different but equally valid quantization of
    the same weights, so the bound is the loose one the JAX package's own
    tests use; it catches a wiring fault on either side."""
    name = "tae_patch128_vocab1024_px256"
    jtok = JTokenizer.from_checkpoint(name, dtype=jnp.float32,
                                      quantization="int8", **SMALL)
    jm = jtok.model
    params = jax.jit(lambda k: jm.init(k, dtype=jnp.float32))(jax.random.key(0))
    tm = models.create(name, **SMALL)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                           jm.cfg), strict=True)
    from tae_tpu_torch.utils.dtypes import Policy

    tok = Tokenizer(model=int8.prepare_serving_(tm.eval(), "int8"),
                    policy=Policy(torch.float32, torch.float32))
    x = np.random.default_rng(11).integers(0, 256, (2, 3, 256, 256),
                                           dtype=np.uint8)
    z_j, z = np.array(jtok.encode(x)), tok.encode(x)
    assert tuple(z.shape) == (2, 4, 1024)
    rel = float(np.linalg.norm(z.numpy() - z_j) / np.linalg.norm(z_j))
    assert rel < 0.05, rel
    rec_j, rec = np.asarray(jtok.decode(z_j)), tok.decode(z_j)
    rel = float(np.linalg.norm(rec.numpy() - rec_j) / np.linalg.norm(rec_j))
    assert rel < 0.05, rel
