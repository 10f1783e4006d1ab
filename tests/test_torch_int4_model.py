"""The port's int4 (w4a8) serving path vs the JAX package, on the CPU: the
model rewrite (which linears go int4, codes and scales exact), the int4
block and stack, both halves of the model, the int4 ``Tokenizer``, the
serving artifact, and the mixed int4 / int8 rule at a width int4 does not
take.

The JAX side runs its Pallas kernels in interpret mode, composed as its
``blocks_apply`` and ``TAE._blocks_then_head`` compose an int4 tree on its own
accelerator (every block on its own, no LayerNorm chaining, a standalone final
LayerNorm ahead of the int8 head); the port runs its plain versions. The JAX
package's int4 serving tree is carried over with
``serving_state_dict_from_jax``, which repacks the bytes, so both sides hold
the same codes and scales. In interpret mode the JAX block takes the
exact-softmax attention, so the port runs ``serving=False`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.nn import vit as jvit
from tae_tpu.ops.int4 import quantize_params_int4 as j_quantize_params_int4
from tae_tpu.ops.int8 import int8_linear as j_int8_linear
from tae_tpu.ops.int8 import prepare_serving_params as j_prepare_serving
from tae_tpu.ops.int8 import unstack_blocks as j_unstack_blocks
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import (serving_state_dict_from_jax,
                                       state_dict_from_jax)
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops import int4, int8
from tae_tpu_torch.ops.cuda.int4_block import int4_mlp
from tae_tpu_torch.ops.cuda.int4_matmul import int4_matmul_fused, unpack_int4
from tae_tpu_torch.ops.cuda.int8_block import int8_mlp, ln_quant
from tae_tpu_torch.ops.cuda.int8_matmul import int8_matmul_fused
from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
from tae_tpu_torch.tokenizer import Tokenizer
from tae_tpu_torch.utils.dtypes import Policy

NAME = "tae_patch16_vocab16_px256"
# 16 tokens of width 256 (K/2 = 128: the narrowest width int4 takes), MLP
# hidden 1024, two blocks per half
TINY = dict(img_size=64, embed_dim=256, depth=2, num_heads=4,
            decoder_embed_dim=256, decoder_depth=2, decoder_num_heads=4)
# width 128: K/2 = 64, so qkv, proj and fc1 stay int8; fc2 (K = 512) goes int4
NARROW = dict(TINY, embed_dim=128, decoder_embed_dim=128)
BLOCK_H = int8.DEFAULT_BLOCK_H
# Fused int4 path against fused int4 path, same codes and scales, fp32
# activations: the group sums are added in another order (fp32 rounding), and
# a value within that of a rounding tie takes the neighbouring int8 code on
# one side, which the layers after it see. Mean-abs relative error; measured
# 2e-7 to 6e-7 here (no code flipped), the bound leaves room for a few flips.
CHAIN_REL = 5e-3
FP32 = Policy(torch.float32, torch.float32)


def _mean_rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).mean() / np.abs(w).mean())


def _jitter_norms(tree, rng):
    """LN affines away from the identity, so that a dropped LayerNorm shows."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            s = np.asarray(tree["scale"])
            return {"scale": jnp.asarray(s * rng.uniform(0.7, 1.4, s.shape)
                                         .astype(np.float32)),
                    "bias": jnp.asarray(rng.normal(0, 0.1, s.shape)
                                        .astype(np.float32))}
        return {k: _jitter_norms(v, rng) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def jax_float():
    jm = jmodels.create(NAME, **TINY)
    params = _jitter_norms(jm.init(jax.random.key(3)),
                           np.random.default_rng(0))
    return jm, params


@pytest.fixture(scope="module")
def pair(jax_float):
    """(JAX model, its int4 serving tree, the port's model holding the same
    codes and scales)."""
    jm, params = jax_float
    sp = j_prepare_serving(params, "int4")
    tm = models.create(NAME, **TINY)
    int4.quantize_params_int4_(tm, fill=False)
    tm.load_state_dict(serving_state_dict_from_jax(
        jax.tree.map(np.asarray, sp), jm.cfg), strict=True)
    return jm, sp, tm.eval()


@pytest.fixture
def same_block_h(monkeypatch):
    """Pin the JAX int4 MLP's hidden block (default 512) to the port's: it
    is part of the numerics."""
    monkeypatch.setenv("TAE_TPU_INT4_MLP_BH", str(BLOCK_H))


def j_int4_half(half, head, x, cfg):
    """``TAE._blocks_then_head`` over an unstacked int4 tree: each block on
    its own through ``int8_block_apply`` (kernels in interpret mode), the
    final LayerNorm standalone, the int8 head on its float output."""
    for layer in half["blocks"]:
        x = jvit.int8_block_apply(layer, x, cfg, interpret=True)
    x = jvit.layer_norm_apply(half["norm"], x, 1e-6)
    p = half[head]
    return j_int8_linear(x, p["w_q"], p["w_scale"], p.get("b"), interpret=True)


# ------------------------------------------------------------- model rewrite

def test_port_int4_rewrite_equals_jax_rewrite(jax_float):
    """Code for code and scale for scale against ``quantize_params_int4``
    run eagerly (under ``jit`` XLA turns ``/ 7`` into a multiplication and
    the scales move by an ulp), through the bridge's repacking."""
    jm, params = jax_float
    sp = j_unstack_blocks(j_quantize_params_int4(params))
    want = serving_state_dict_from_jax(jax.tree.map(np.asarray, sp), jm.cfg)
    tm = models.create(NAME, **TINY)
    tm.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jm.cfg), strict=True)
    int8.prepare_serving_(tm, "int4")
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    n4 = sum(isinstance(m, vit.Q4Linear) for m in tm.modules())
    n8 = sum(isinstance(m, vit.QLinear) for m in tm.modules())
    assert (n4, n8) == (4 * (2 + 2), 3)           # heads and decoder_embed
    assert isinstance(tm.patch_embed.proj, vit.PatchProj)        # float
    assert got["blocks.0.attn.qkv.w4"].dtype == torch.uint8
    assert tuple(got["blocks.0.attn.qkv.w4"].shape) == (768, 128)
    assert tuple(got["blocks.0.mlp.fc2.w4_scale"].shape) == (4, 256)
    assert all(not p.requires_grad for p in tm.parameters())
    # int4 never quantizes the patch embedding, whatever patch_input says
    tm2 = models.create(NAME, **TINY)
    tm2.init_weights_(torch.Generator().manual_seed(0))
    int8.prepare_serving_(tm2, "int4", patch_input=True)
    assert isinstance(tm2.patch_embed.proj, vit.PatchProj)


def test_bridge_carries_the_jax_int4_tree(pair):
    jm, sp, tm = pair
    q = sp["encoder"]["blocks"][1]["mlp"]["fc1"]
    lin = tm.blocks[1].mlp.fc1
    assert isinstance(lin, vit.Q4Linear) and lin.w4.dtype == torch.uint8
    b = np.asarray(q["w4"]).astype(np.int32)
    codes = np.concatenate([(b & 15) - 8, b >> 4], axis=0)       # (K, N)
    assert np.array_equal(unpack_int4(lin.w4).numpy().T, codes)
    assert np.array_equal(lin.w4_scale.numpy(), np.asarray(q["w4_scale"]))
    head = tm.dict_proj
    assert isinstance(head, vit.QLinear)
    assert np.array_equal(head.w_q.numpy().T,
                          np.asarray(sp["encoder"]["dict_proj"]["w_q"]))


def test_width_128_falls_to_int8_and_mixes(jax_float):
    """The mixed rule: at width 128 ``int4_ok`` is false for qkv, proj and
    fc1 (K / 2 = 64) and true for fc2 (K = 512). Both packages decide the
    same leaves; the port's block runs (its MLP unfused through the two
    quantized linears) and stays close to the float block."""
    jm = jmodels.create(NAME, **NARROW)
    params = jm.init(jax.random.key(4))
    sp = j_unstack_blocks(j_quantize_params_int4(params))
    layer = sp["encoder"]["blocks"][0]
    assert "w_q" in layer["attn"]["qkv"] and "w_q" in layer["mlp"]["fc1"]
    assert "w4" in layer["mlp"]["fc2"]
    tm = models.create(NAME, **NARROW)
    tm.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jm.cfg), strict=True)
    fm = models.create(NAME, **NARROW)
    fm.load_state_dict(tm.state_dict())
    int8.prepare_serving_(tm, "int4")
    want = serving_state_dict_from_jax(jax.tree.map(np.asarray, sp), jm.cfg)
    got = tm.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    blk = tm.blocks[0]
    assert isinstance(blk.attn.qkv, vit.QLinear)
    assert isinstance(blk.mlp.fc1, vit.QLinear)
    assert isinstance(blk.mlp.fc2, vit.Q4Linear)
    assert blk.is_int8 and not blk.chains_ln
    x = torch.randn((2, 16, 128), generator=torch.Generator().manual_seed(1))
    y, ln = blk.forward_int8(x)
    assert ln is None
    rel = float((y - fm.blocks[0](x)).norm() / fm.blocks[0](x).norm())
    assert rel < 0.1, rel
    imgs = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(2))
    z, zf = (m.forward_encoder(imgs, policy=FP32) for m in (tm, fm))
    assert float((z - zf).norm() / zf.norm()) < 0.15


# ---------------------------------------------------- block, stack, halves

def test_int4_block_matches_jax(pair, same_block_h):
    """One int4 block against ``int8_block_apply(pq, x, cfg,
    interpret=True)``: ln_quant, int4 qkv, attention, int4 proj with the
    residual, ln_quant, the fused int4 MLP."""
    jm, sp, tm = pair
    x = np.random.default_rng(13).standard_normal((2, 16, 256)).astype(np.float32)
    want = jvit.int8_block_apply(sp["encoder"]["blocks"][0], jnp.asarray(x),
                                 jm.cfg.enc_block, interpret=True)
    got, ln = tm.blocks[0].forward_int8(torch.from_numpy(x))
    assert ln is None
    rel = _mean_rel(got, want)
    assert rel <= CHAIN_REL, rel
    assert torch.equal(tm.blocks[0](torch.from_numpy(x)), got)
    assert tm.blocks[0].is_int8 and not tm.blocks[0].chains_ln
    with pytest.raises(ValueError, match="chains"):
        tm.blocks[0].forward_int8(torch.from_numpy(x),
                                  norm1_next=tm.blocks[1].norm1)


def test_jax_block_depends_on_the_hidden_block(pair, monkeypatch):
    """Without the pin the JAX MLP requantizes per 512 hidden columns: a
    different (equally valid) quantization, visibly further away."""
    jm, sp, tm = pair
    x = np.random.default_rng(14).standard_normal((2, 16, 256)).astype(np.float32)
    layer, cfg = sp["encoder"]["blocks"][0], jm.cfg.enc_block
    monkeypatch.setenv("TAE_TPU_INT4_MLP_BH", "512")
    other = jvit.int8_block_apply(layer, jnp.asarray(x), cfg, interpret=True)
    monkeypatch.setenv("TAE_TPU_INT4_MLP_BH", str(BLOCK_H))
    same = jvit.int8_block_apply(layer, jnp.asarray(x), cfg, interpret=True)
    got, _ = tm.blocks[0].forward_int8(torch.from_numpy(x))
    assert _mean_rel(got, same) * 20 < _mean_rel(got, other)
    assert tm.blocks[0].mlp.block_h == BLOCK_H


def test_int4_stack_runs_unchained(pair):
    """No LayerNorm chains between int4 blocks or into the head: the stack
    equals the blocks one by one, and ``final_norm`` gets no chained
    output."""
    jm, sp, tm = pair
    x = torch.randn((1, 16, 256), generator=torch.Generator().manual_seed(0))
    want = x
    for blk in tm.blocks:
        want = blk(want)
    assert torch.equal(vit.blocks_apply(tm.blocks, x), want)
    got, ln = vit.blocks_apply(tm.blocks, x, final_norm=tm.norm)
    assert ln is None and torch.equal(got, want)


def test_int4_block_behind_an_int8_block_is_not_chained_into(pair):
    jm, sp, tm = pair
    blk8 = vit.Block(vit.BlockConfig(256, 4))
    vit.init_weights_(blk8, torch.Generator().manual_seed(5))
    holder = torch.nn.ModuleList([blk8])
    int8.quantize_params_(holder)
    assert blk8.chains_ln
    stack = torch.nn.ModuleList([blk8, tm.blocks[0], blk8])
    x = torch.randn((1, 16, 256), generator=torch.Generator().manual_seed(6))
    got, ln = vit.blocks_apply(stack, x, final_norm=tm.norm)
    want = x
    for blk in stack:
        want = blk(want)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert ln is not None and ln[0].dtype == torch.int8      # last block: int8


def test_int4_halves_match_jax_composition(pair, same_block_h):
    """The slice as a whole, per half: patch embed (float), position add,
    the int4 blocks, the standalone final LayerNorm, the int8 head."""
    jm, sp, tm = pair
    rng = np.random.default_rng(21)
    imgs = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    enc, dec, c = sp["encoder"], sp["decoder"], jm.cfg
    x = jvit.patch_embed_apply(enc["patch_embed"], jnp.asarray(imgs),
                               c.patch_size) + enc["pos_embed"]
    z_j = j_int4_half(enc, "dict_proj", x, c.enc_block)
    z = tm.forward_encoder(torch.from_numpy(imgs), policy=FP32)
    assert tuple(z.shape) == (2, 16, 16) and z.dtype == torch.float32
    rel = _mean_rel(z, z_j)
    assert rel <= CHAIN_REL, rel
    zin = np.asarray(z_j)
    e = dec["embed"]
    x = j_int8_linear(jnp.asarray(zin), e["w_q"], e["w_scale"], e["b"],
                      interpret=True) + dec["pos_embed"]
    rec_j = j_int4_half(dec, "pred", x, c.dec_block)
    rec = tm.forward_decoder(torch.from_numpy(zin.copy()), policy=FP32)
    assert tuple(rec.shape) == (2, 16, 768)
    rel = _mean_rel(rec, rec_j)
    # On these latents one code of the first decoder block sits on a
    # rounding tie and flips (its output moves by 1.5e-4 in the mean, 0.013
    # at the worst element); the second block requantizes that and the head
    # sees 6.2e-3. Four times CHAIN_REL covers a flip amplified by the
    # blocks after it; on random latents the same half agrees to 1e-7.
    assert rel <= 4 * CHAIN_REL, rel
    zr = rng.standard_normal((2, 16, 16)).astype(np.float32)
    x = j_int8_linear(jnp.asarray(zr), e["w_q"], e["w_scale"], e["b"],
                      interpret=True) + dec["pos_embed"]
    rel = _mean_rel(tm.forward_decoder(torch.from_numpy(zr), policy=FP32),
                    j_int4_half(dec, "pred", x, c.dec_block))
    assert rel <= CHAIN_REL, rel


# ---------------------------------------------------------------- tokenizer

@pytest.fixture(scope="module")
def int4_tokenizers(tmp_path_factory):
    """The JAX int4 Tokenizer and the port's, from the same float weights
    (the JAX Tokenizer's own seeded init, carried over as a ``.pth``)."""
    jtok = JTokenizer.from_checkpoint(NAME, dtype=jnp.float32,
                                      quantization="int4", **TINY)
    jm = jtok.model
    params = jax.jit(lambda k: jm.init(k, dtype=jnp.float32))(jax.random.key(0))
    path = tmp_path_factory.mktemp("ckpt") / "float.pth"
    torch.save(state_dict_from_jax(jax.tree.map(np.asarray, params), jm.cfg),
               path)
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                    device="cpu", quantization="int4", **TINY)
    return jtok, tok, path


def test_int4_tokenizer_matches_jax_int4_tokenizer(int4_tokenizers):
    """On the CPU the JAX Tokenizer takes its unfused fallback (dequantized
    fp32 weights, one hidden scale per row): a different but equally valid
    evaluation of the same codes. The bound is the loose one its own tests
    use, and catches a wiring fault on either side."""
    jtok, tok, _ = int4_tokenizers
    q = jtok.params["encoder"]["blocks"][0]["mlp"]["fc1"]
    fc1 = tok.model.blocks[0].mlp.fc1
    # the JAX side quantized under jit: scales one ulp apart, a few codes on
    # a rounding tie one step apart
    np.testing.assert_allclose(fc1.w4_scale.numpy(), np.asarray(q["w4_scale"]),
                               rtol=1e-6)
    b = np.asarray(q["w4"]).astype(np.int32)
    codes = np.concatenate([(b & 15) - 8, b >> 4], axis=0)
    diff = np.abs(unpack_int4(fc1.w4).numpy().T.astype(np.int32) - codes)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    x = np.random.default_rng(11).integers(0, 256, (2, 3, 64, 64),
                                           dtype=np.uint8)
    z_j, z = np.asarray(jtok.encode(x)), tok.encode(x)
    assert tuple(z.shape) == (2, 16, 16) and z.dtype == torch.float32
    rel = float(np.linalg.norm(z.numpy() - z_j) / np.linalg.norm(z_j))
    assert rel < 0.05, rel
    rec_j, rec = np.asarray(jtok.decode(z_j)), tok.decode(z_j.copy())
    assert tuple(rec.shape) == (2, 3, 64, 64)
    rel = float(np.linalg.norm(rec.numpy() - rec_j) / np.linalg.norm(rec_j))
    assert rel < 0.05, rel


def test_int4_tokenizer_close_to_float_tokenizer(int4_tokenizers):
    """int4 is a coarser code than int8 (0.05 there): 3x its bound."""
    _, tok, path = int4_tokenizers
    ftok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                     device="cpu", **TINY)
    x = np.random.default_rng(12).integers(0, 256, (2, 3, 64, 64),
                                           dtype=np.uint8)
    z, zf = tok.encode(x), ftok.encode(x)
    rel = float((z - zf).norm() / zf.norm())
    assert 1e-4 < rel < 0.15, rel
    # equalize= works with int4 and changes the weights, not what they compute
    etok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                     device="cpu", quantization="int4",
                                     equalize=True, **TINY)
    assert not torch.equal(etok.model.blocks[0].attn.qkv.w4,
                           tok.model.blocks[0].attn.qkv.w4)
    assert float((etok.encode(x) - zf).norm() / zf.norm()) < 0.15
    # and it equals the JAX package's equalize -> int4 rewrite
    assert isinstance(etok.model.blocks[0].attn.qkv, vit.Q4Linear)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_serving_artifact_round_trip(int4_tokenizers, tmp_path, dtype):
    _, _, ckpt = int4_tokenizers
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(ckpt), dtype=dtype,
                                    device="cpu", quantization="int4", **TINY)
    path = tmp_path / "tok.int4.pt"
    tok.save_serving(path)
    blob = torch.load(path, weights_only=True)
    assert blob["serving"] is True and blob["mlp_block_h"] == BLOCK_H
    assert blob["int4_layout"] == int4.LAYOUT and "int4_group" not in blob
    # a leaf's group follows from its shapes, which the load holds to the rule
    qkv = blob["model"]["blocks.0.attn.qkv.w4_scale"]
    width = TINY["embed_dim"]
    assert qkv.shape[0] * int4.group_size(width // 2) == width
    assert len(blob["int4"]) == 16 and len(blob["quantized"]) == 3
    assert "blocks.0.attn.qkv" in blob["int4"]
    assert blob["model"]["blocks.0.attn.qkv.w4"].dtype == torch.uint8
    back = Tokenizer.from_serving(NAME, path, device="cpu", **TINY)
    assert back.policy.compute_dtype == dtype
    x = np.random.default_rng(13).integers(0, 256, (2, 3, 64, 64),
                                           dtype=np.uint8)
    z = tok.encode(x)
    assert torch.equal(back.encode(x), z)                 # bit-identical
    assert torch.equal(back.decode(z), tok.decode(z))
    enc = Tokenizer.from_serving(NAME, path, device="cpu", component="encoder",
                                 **TINY)
    assert torch.equal(enc.encode(x), z) and not enc.model.has_decoder
    # an artifact packed another way is refused, not misread
    blob["int4_layout"] = "nibble-planes"
    torch.save(blob, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="packed as 'nibble-planes'"):
        Tokenizer.from_serving(NAME, tmp_path / "other.pt", device="cpu",
                               **TINY)
    # and one with another scale group does not load: the shapes disagree
    blob["int4_layout"] = int4.LAYOUT
    blob["model"]["blocks.0.attn.qkv.w4_scale"] = qkv.repeat_interleave(2, 0)
    torch.save(blob, tmp_path / "group.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        Tokenizer.from_serving(NAME, tmp_path / "group.pt", device="cpu",
                               **TINY)


def test_artifact_without_the_int4_fields_still_loads(tmp_path):
    """The format written before the int4 mode existed: no ``int4`` or
    ``int4_layout`` keys."""
    tok = Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                    **TINY)
    tok.save_serving(tmp_path / "new.pt")
    blob = torch.load(tmp_path / "new.pt", weights_only=True)
    assert blob["int4"] == [] and blob["int4_layout"] is None
    for key in ("int4", "int4_layout"):
        del blob[key]
    torch.save(blob, tmp_path / "old.pt")
    back = Tokenizer.from_serving(NAME, tmp_path / "old.pt", device="cpu",
                                  **TINY)
    x = np.random.default_rng(14).integers(0, 256, (1, 3, 64, 64),
                                           dtype=np.uint8)
    assert torch.equal(back.encode(x), tok.encode(x))
    assert not any(isinstance(m, vit.Q4Linear) for m in back.model.modules())


def test_int4_serving_refuses_gradients_and_leaves_counters_at_zero(
        int4_tokenizers):
    _, tok, _ = int4_tokenizers
    x = np.random.default_rng(15).integers(0, 256, (1, 3, 64, 64),
                                           dtype=np.uint8)
    tok.reconstruct(x)
    for fn in (ln_quant, int4_matmul_fused, int4_mlp, int8_matmul_fused,
               int8_mlp, fused_layer_norm):
        assert fn.launches == 0, fn.__name__
    h = torch.randn((1, 16, 256), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tok.model.blocks[0](h)
