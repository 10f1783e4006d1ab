"""Port Tokenizer vs the JAX Tokenizer: bf16 serving on uint8 and float
batches, a reference ``.pth`` from the JAX exporter, pruning, and the parts
that are not ported yet (int8 serving: tests/test_torch_int8_model.py).

JAX runs its Tokenizer on the CPU (XLA attention, exact softmax); the port
runs its plain versions with the serving softmax, which equals the exact
form while scores stay inside its clamp, as they do here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import save_torch_checkpoint, tae_state_dict
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ops.cuda.flash_attention import fused_qkv_attention
from tae_tpu_torch.ops.cuda.int8_block import int8_mlp, ln_quant
from tae_tpu_torch.ops.cuda.int8_matmul import int8_matmul_fused
from tae_tpu_torch.ops.cuda.layernorm import fused_layer_norm
from tae_tpu_torch.tokenizer import Tokenizer, prune_component
from tae_tpu_torch.utils.dtypes import Policy

NAME = "tae_patch16_vocab16_px256"
TINY = dict(img_size=64, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=48, decoder_depth=2, decoder_num_heads=4)
# bf16 end to end, same reasoning and bound as tests/test_torch_model.py
# BF16_REL: different rounding points over two blocks per half; the
# measured error is a few 1e-3, any real fault is O(1).
BF16_REL = 2e-2
FP32_TOL = dict(atol=2e-5, rtol=1e-4)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def jax_model():
    jm = jmodels.create(NAME, **TINY)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.key(3)))


@pytest.fixture(scope="module")
def bf16_pair(jax_model):
    jm, params = jax_model
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jtok = JTokenizer(model=jm, params=jparams,
                      policy=JPolicy(jnp.bfloat16, jnp.bfloat16))
    tm = models.create(NAME, **TINY)
    tm.load_state_dict(tae_state_dict(params, jm.cfg), strict=True)
    tok = Tokenizer(model=tm.to(torch.bfloat16).eval(),
                    policy=Policy(torch.bfloat16, torch.bfloat16))
    return jtok, tok


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return {"uint8": rng.integers(0, 256, (2, 3, 64, 64), dtype=np.uint8),
            "float": rng.standard_normal((2, 3, 64, 64)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_bf16_encode_decode_reconstruct_match_jax(bf16_pair, images, kind):
    jtok, tok = bf16_pair
    x = images[kind]
    z_j, z = jtok.encode(x), tok.encode(x)
    assert z.dtype == torch.bfloat16 and tuple(z.shape) == (2, 16, 16)
    assert _rel(z, z_j) < BF16_REL
    # decode the same latents on both sides
    zin = _f32(z_j)
    rec = tok.decode(zin)
    assert tuple(rec.shape) == (2, 3, 64, 64) and rec.dtype == torch.bfloat16
    assert _rel(rec, jtok.decode(zin)) < BF16_REL
    assert _rel(tok.reconstruct(x), jtok.reconstruct(x)) < BF16_REL


def test_pth_from_jax_exporter_fp32_matches_jax(jax_model, images, tmp_path):
    """A JAX checkpoint reaches the port as the ``.pth`` that
    ``python -m tae_tpu.cli.export_torch`` writes."""
    jm, params = jax_model
    path = tmp_path / "tae.pth"
    save_torch_checkpoint(path, jm, params, step=7)
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                    device="cpu", **TINY)
    jtok = JTokenizer(model=jm, params=params,
                      policy=JPolicy(jnp.float32, jnp.float32))
    x = images["float"]
    np.testing.assert_allclose(_f32(tok.encode(x)), _f32(jtok.encode(x)),
                               **FP32_TOL)
    np.testing.assert_allclose(_f32(tok.reconstruct(x)),
                               _f32(jtok.reconstruct(x)), **FP32_TOL)
    # a bare state_dict file loads the same way
    torch.save(tae_state_dict(params, jm.cfg), tmp_path / "bare.pth")
    tok2 = Tokenizer.from_checkpoint(NAME, ckpt=str(tmp_path / "bare.pth"),
                                     dtype=torch.float32, device="cpu", **TINY)
    assert torch.equal(tok2.encode(x), tok.encode(x))


def test_from_checkpoint_seeded_init_and_dtype():
    a = Tokenizer.from_checkpoint(NAME, device="cpu", seed=5, **TINY)
    b = Tokenizer.from_checkpoint(NAME, device="cpu", seed=5, **TINY)
    assert all(p.dtype == torch.bfloat16 for p in a.model.parameters())
    assert all(torch.equal(p, q) for p, q in
               zip(a.model.parameters(), b.model.parameters()))
    assert a.policy.compute_dtype == torch.bfloat16
    assert a.device == torch.device("cpu")


def test_default_device_is_cuda_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        Tokenizer.from_checkpoint(NAME, **TINY)


@pytest.mark.parametrize("component", ["encoder", "decoder"])
def test_prune_component(images, component):
    tok = Tokenizer.from_checkpoint(NAME, device="cpu", component=component,
                                    **TINY)
    keys = list(tok.model.state_dict())
    x = images["uint8"]
    if component == "encoder":
        assert not any(k.startswith("decoder") for k in keys)
        z = tok.encode(x)
        with pytest.raises(ValueError, match="decoder was pruned"):
            tok.decode(z)
    else:
        assert all(k.startswith("decoder") for k in keys)
        assert tuple(tok.decode(torch.zeros(1, 16, 16)).shape) == (1, 3, 64, 64)
        with pytest.raises(ValueError, match="encoder was pruned"):
            tok.encode(x)
    with pytest.raises(ValueError, match="unknown component"):
        prune_component(tok.model, "middle")


def test_unported_parts_raise():
    # measured statistics (ROADMAP A8) are ported: a calibration run needs
    # equalize= and at least one batch
    with pytest.raises(ValueError, match="require equalize"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                  act_amax={}, **TINY)
    with pytest.raises(ValueError, match="calibration batch"):
        Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                  equalize=True, calib_images=[], **TINY)
    # int4 serving and discrete tokens are ported: they build and run (a
    # model without a codebook says how to get one)
    tok4 = Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int4",
                                     component="encoder", **TINY)
    x = np.zeros((1, 3, 64, 64), np.uint8)
    assert tuple(tok4.encode(x).shape) == (1, 16, 16)
    tok = Tokenizer.from_checkpoint(NAME, device="cpu", **TINY)
    with pytest.raises(ValueError, match="quantize=True"):
        tok.encode_discrete(x)
    with pytest.raises(ValueError, match="quantize=True"):
        tok.decode_discrete(np.zeros((1, 16), np.int64))
    vq = Tokenizer.from_checkpoint(NAME, device="cpu", quantize=True,
                                   codebook_size=32, **TINY)
    ids = vq.encode_discrete(x)
    assert tuple(ids.shape) == (1, 16) and int(ids.max()) < 32
    assert tuple(vq.decode_discrete(ids).shape) == (1, 3, 64, 64)


def test_cpu_serving_leaves_launch_counters_at_zero(bf16_pair, images):
    _, tok = bf16_pair
    tok.reconstruct(images["uint8"])
    tok8 = Tokenizer.from_checkpoint(NAME, device="cpu", quantization="int8",
                                     **dict(TINY, decoder_embed_dim=64))
    tok8.reconstruct(images["uint8"])
    for fn in (fused_layer_norm, fused_qkv_attention, ln_quant,
               int8_matmul_fused, int8_mlp):
        assert fn.launches == 0, fn.__name__
