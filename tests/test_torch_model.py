"""Port TAE vs the JAX TAE: weight bridge, fp32 and bf16 forward parity,
registry and full-width parameter counts.

The JAX model's parameters (numpy, from ``model.init``) reach the port
through ``state_dict_from_jax``; both run the same numpy inputs. JAX runs
its XLA paths on the CPU (tests/conftest.py), the port its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ckpt.torch_export import tae_state_dict
from tae_tpu.models import list_models as j_list_models
from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.ops.patchify import extract_patches
from tae_tpu_torch.utils.dtypes import FP32, Policy

TINY = dict(img_size=64, patch_size=16, embed_dim=64, vocab_size=16, depth=2,
            num_heads=4, decoder_embed_dim=48, decoder_depth=2,
            decoder_num_heads=4)
# fp32 bound of tests/test_torch_parity.py:33 (JAX vs the PyTorch reference)
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 end to end: both sides round every matmul output, bias add, GELU and
# residual to bf16 (2^-8 relative steps), but at different points (a fused
# bias epilogue here, a separate add there; XLA may fuse elementwise chains
# in fp32). Two blocks per half of such independent roundings measured
# 5.6e-3 (encoder) and 6.5e-3 (decoder) relative (Frobenius) on these
# inputs; 2e-2 leaves 3x room and still catches any real layout or op-order
# fault, which shows up at O(1).
BF16_REL = 2e-2


def _rel(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def pair():
    jm = JTAE(JTAEConfig(**TINY))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tm = TAE(TAEConfig(**TINY))
    tm.load_state_dict(state_dict_from_jax(params, jm.cfg), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(42).standard_normal((2, 3, 64, 64)).astype(np.float32)


def test_bridge_equals_torch_export_key_for_key(pair):
    jm, params, tm = pair
    want = tae_state_dict(params, jm.cfg)
    got = state_dict_from_jax(params, jm.cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert set(tm.state_dict()) == set(want)


def test_strict_load_rejects_missing_and_misshaped(pair):
    jm, params, _ = pair
    sd = state_dict_from_jax(params, jm.cfg)
    tm = TAE(TAEConfig(**TINY))
    with pytest.raises(RuntimeError, match="Missing"):
        tm.load_state_dict({k: v for k, v in sd.items() if k != "pos_embed"})
    sd["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"].reshape(64, -1)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tm.load_state_dict(sd)


def test_encoder_fp32_parity(pair, imgs):
    jm, params, tm = pair
    want = jm.forward_encoder(params, jnp.asarray(imgs), policy=J_FP32)
    got = tm.forward_encoder(torch.from_numpy(imgs), policy=FP32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    # pre-patchified (B, N, C·p²) rows take the same path after the relayout
    rows = extract_patches(torch.from_numpy(imgs), 16)
    np.testing.assert_array_equal(tm.forward_encoder(rows, policy=FP32).numpy(),
                                  got.numpy())


def test_decoder_fp32_parity(pair):
    jm, params, tm = pair
    z = np.random.default_rng(7).standard_normal((2, 16, 16)).astype(np.float32)
    want = jm.forward_decoder(params, jnp.asarray(z), policy=J_FP32)
    got = tm.forward_decoder(torch.from_numpy(z), policy=FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tm.unpatchify(got).numpy(),
                               np.asarray(jm.unpatchify(want)), **FP32_TOL)


def test_forward_loss_fp32_parity(pair, imgs):
    jm, params, tm = pair
    loss_j, pred_j = jm.forward(params, jnp.asarray(imgs), policy=J_FP32)
    loss, pred = tm.forward(torch.from_numpy(imgs), policy=FP32)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_j), **FP32_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("half", ["encoder", "decoder"])
def test_bf16_parity(pair, imgs, half):
    jm, params, tm = pair
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jpol = JPolicy(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    pol = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    tm16 = TAE(TAEConfig(**TINY)).to(torch.bfloat16)
    tm16.load_state_dict(tm.state_dict())
    if half == "encoder":
        want = jm.forward_encoder(jparams, jnp.asarray(imgs), policy=jpol)
        got = tm16.forward_encoder(torch.from_numpy(imgs), policy=pol)
    else:
        z = np.random.default_rng(8).standard_normal((2, 16, 16)).astype(np.float32)
        want = jm.forward_decoder(jparams, jnp.asarray(z), policy=jpol)
        got = tm16.forward_decoder(torch.from_numpy(z), policy=pol)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got, want) < BF16_REL


def test_shape_errors_and_unported_options():
    tm = TAE(TAEConfig(**TINY), device="meta")
    with pytest.raises(ValueError, match="img_size"):
        tm.forward_encoder(torch.zeros(1, 3, 32, 32), policy=FP32)
    with pytest.raises(ValueError, match="pre-patchified"):
        tm.forward_encoder(torch.zeros(1, 16, 10), policy=FP32)
    # the VQ bottleneck is ported: quantize=True adds the codebook parameter
    vq = TAE(TAEConfig(**TINY, quantize=True, codebook_size=24), device="meta")
    assert tuple(vq.codebook.shape) == (24, TINY.get("vocab_size", 16))
    assert not hasattr(tm, "codebook")
    # qk_norm attention is ported: a LayerNorm over each head's dh columns
    # of q and of k (tests/test_torch_qk_norm.py holds it to the JAX block)
    from tae_tpu_torch.nn.vit import Attention, AttentionConfig

    attn = Attention(AttentionConfig(64, 4, qk_norm=True), device="meta")
    assert attn.qk_norm and tuple(attn.q_norm.weight.shape) == (16,)
    assert tuple(attn.k_norm.bias.shape) == (16,)
    assert not Attention(AttentionConfig(64, 4), device="meta").qk_norm


def test_registry_names_match_jax():
    assert models.list_models("tae_") == j_list_models("tae_")
    assert len(models.list_models("tae_")) == 12
    with pytest.raises(KeyError, match="unknown model"):
        models.create("tae_patch8_vocab1_px256")


@pytest.mark.parametrize("name", [
    "tae_patch16_vocab16_px256", "tae_patch16_vocab64_px256",
    "tae_patch16_vocab256_px256", "tae_patch32_vocab64_px256",
    "tae_patch32_vocab256_px256", "tae_patch32_vocab1024_px256",
    "tae_patch64_vocab256_px256", "tae_patch64_vocab1024_px256",
    "tae_patch64_vocab4096_px256", "tae_patch128_vocab1024_px256",
    "tae_patch128_vocab4096_px256", "tae_patch128_vocab16384_px256"])
def test_full_width_param_count_matches_jax(name):
    from tae_tpu import models as jmodels

    jm = jmodels.create(name)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tm = models.create(name, device="meta")
    assert sum(p.numel() for p in tm.parameters()) == want


def test_init_distributions():
    """Values cannot match JAX's threefry draws; the distributions must:
    xavier-uniform bounds and spread, trunc-normal(0.02) positions."""
    cfg = TAEConfig(**TINY)
    tm = TAE(cfg).init_weights_(torch.Generator().manual_seed(0))
    w = tm.blocks[0].mlp.fc1.weight                    # (256, 64)
    limit = (6.0 / (64 + 256)) ** 0.5
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / 3 ** 0.5) < 0.05 * limit
    pe = tm.patch_embed.proj.weight                    # fan_in C·p², fan_out E
    assert float(pe.abs().max()) <= (6.0 / (3 * 16 * 16 + 64)) ** 0.5
    assert abs(float(tm.pos_embed.std()) - 0.02) < 0.002
    assert torch.equal(tm.norm.weight, torch.ones(64))
    assert not tm.blocks[1].attn.qkv.bias.any()
