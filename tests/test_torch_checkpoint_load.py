"""Checkpoints between the port and the JAX package: ``Tokenizer.from_checkpoint``
loads as the JAX ``Tokenizer`` does (``tae_tpu_torch.ckpt.io.load_params``:
positional embeddings interpolated to another token grid, keys the file lacks
kept at their initial values, keys the model lacks dropped), and a checkpoint
the port saves loads into the JAX package.

Both sides run fp32 on the CPU, the JAX side with its XLA attention. The
weights are made by the JAX package from a seed and cross as the ``.pth``
that ``python -m tae_tpu.cli.export_torch`` writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.io import load_params as j_load_params
from tae_tpu.ckpt.torch_export import save_torch_checkpoint, tae_state_dict
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.ckpt.io import load_params, save_checkpoint
from tae_tpu_torch.tokenizer import Tokenizer
from tae_tpu_torch.train import TrainState, adamw
from tae_tpu_torch.utils.dtypes import Policy

NAME = "tae_patch16_vocab16_px256"
TINY = dict(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=48,
            decoder_depth=2, decoder_num_heads=4)
# fp32 on both sides, sums in another order (tests/test_torch_tokenizer.py)
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
FP32 = Policy(torch.float32, torch.float32, torch.float32)
JFP32 = JPolicy(jnp.float32, jnp.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def px256_pth(tmp_path_factory):
    """A JAX model at its registry image size (256 px: a 16 x 16 token
    grid), exported as a reference-layout ``.pth``."""
    jm = jmodels.create(NAME, **TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(11)))
    path = tmp_path_factory.mktemp("ckpt") / "px256.pth"
    save_torch_checkpoint(path, jm, params, step=3)
    return path, jm, params


@pytest.mark.parametrize("img_size", [128, 64])
def test_img_size_override_interpolates_like_jax(px256_pth, img_size):
    """The checkpoint's 16 x 16 position embeddings meet a model of another
    token grid: both loaders interpolate them, and the two tokenizers agree
    (a strict load, as the port did before, raised on the shape)."""
    path, _, params = px256_pth
    kw = dict(TINY, img_size=img_size)
    jtok = JTokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=jnp.float32,
                                      **kw)
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                    device="cpu", **kw)
    grid = (img_size // 16) ** 2
    assert tuple(tok.model.pos_embed.shape) == (1, grid, 64)
    np.testing.assert_allclose(_f32(tok.model.pos_embed),
                               _f32(jtok.params["encoder"]["pos_embed"]),
                               atol=1e-6, rtol=1e-5)
    # everything but the position embeddings is the file's, bit for bit
    want = state_dict_from_jax(params, jmodels.create(NAME, **TINY).cfg)
    got = tok.model.state_dict()
    for k, v in want.items():
        if "pos_embed" not in k:
            assert torch.equal(got[k], v), k
    x = np.random.default_rng(img_size).standard_normal(
        (2, 3, img_size, img_size)).astype(np.float32)
    np.testing.assert_allclose(_f32(tok.encode(x)), _f32(jtok.encode(x)),
                               **FP32_TOL)
    np.testing.assert_allclose(_f32(tok.reconstruct(x)),
                               _f32(jtok.reconstruct(x)), **FP32_TOL)
    with pytest.raises(RuntimeError, match="pos_embed"):
        models.create(NAME, **kw).load_state_dict(
            torch.load(path, weights_only=True)["model"], strict=True)


def test_continuous_checkpoint_loads_with_quantize(px256_pth, tmp_path):
    """A continuous model's checkpoint under ``quantize=True``: the file has
    no codebook, so both packages keep the initial one (each its own seeded
    init) and load everything else; with the JAX codebook copied over, the
    discrete tokens are the JAX tokenizer's. A key the model lacks is
    dropped."""
    path, jm, params = px256_pth
    kw = dict(TINY, img_size=64, quantize=True, codebook_size=40)
    jtok = JTokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=jnp.float32,
                                      **kw)
    sd = torch.load(path, weights_only=True)
    sd["model"]["head.weight"] = torch.zeros(3, 3)         # not in the model
    torch.save(sd, tmp_path / "extra.pth")
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(tmp_path / "extra.pth"),
                                    dtype=torch.float32, device="cpu", seed=4,
                                    **kw)
    fresh = Tokenizer.from_checkpoint(NAME, dtype=torch.float32, device="cpu",
                                      seed=4, **kw)
    assert torch.equal(tok.model.codebook, fresh.model.codebook)
    assert not torch.equal(tok.model.dict_proj.weight,
                           fresh.model.dict_proj.weight)
    assert "head.weight" not in tok.model.state_dict()
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    np.testing.assert_allclose(_f32(tok.encode(x)), _f32(jtok.encode(x)),
                               **FP32_TOL)
    # the codebook on the latents' scale, the same on both sides
    cb = np.random.default_rng(3).standard_normal((40, 16)).astype(np.float32)
    with torch.no_grad():
        tok.model.codebook.copy_(torch.from_numpy(cb))
    jtok.params = dict(jtok.params, codebook=jnp.asarray(cb))
    ids = tok.encode_discrete(x)
    assert np.array_equal(ids.numpy(), np.asarray(jtok.encode_discrete(x)))
    assert len(np.unique(ids.numpy())) > 3


@pytest.mark.parametrize("with_optimizer", [False, True])
def test_port_checkpoint_loads_into_the_jax_package(with_optimizer, tmp_path):
    """``tae_tpu_torch.ckpt.io.save_checkpoint`` (a model, or a whole train
    state) read by ``tae_tpu.ckpt.io.load_params``: the same parameters,
    and the same forward."""
    jm = jmodels.create(NAME, **dict(TINY, img_size=64))
    tm = models.create(NAME, trainable=with_optimizer, **dict(TINY, img_size=64))
    tm.init_weights_(torch.Generator().manual_seed(21))
    state = TrainState.create(tm, adamw(weight_decay=0.05)) \
        if with_optimizer else tm
    path = tmp_path / "port.pt"
    save_checkpoint(path, state, step=9, args={"note": "port"})
    init = jm.init(jax.random.key(0))
    loaded = j_load_params(path, jm, init)
    back = state_dict_from_jax(jax.tree.map(np.asarray, loaded), jm.cfg)
    own = tm.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k
    imgs = np.random.default_rng(5).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    loss_j, pred_j = jm.forward(loaded, jnp.asarray(imgs), policy=JFP32,
                                backend="xla")
    with torch.no_grad():
        loss, pred = tm(torch.from_numpy(imgs), policy=FP32)
    np.testing.assert_allclose(_f32(pred), _f32(pred_j), **FP32_TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    # and the port reads its own file back the same way
    again = models.create(NAME, **dict(TINY, img_size=64))
    load_params(path, again)
    assert all(torch.equal(a, b) for a, b in
               zip(again.state_dict().values(), tm.state_dict().values()))


def test_bare_state_dict_and_reference_pth_load_alike(px256_pth, tmp_path):
    """A bare state_dict file and the exporter's ``{"model": ...}`` file give
    the same tokenizer, with and without an image-size override."""
    path, jm, params = px256_pth
    torch.save(tae_state_dict(params, jm.cfg), tmp_path / "bare.pth")
    for kw in (TINY, dict(TINY, img_size=128)):
        a = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                      device="cpu", **kw)
        b = Tokenizer.from_checkpoint(NAME, ckpt=str(tmp_path / "bare.pth"),
                                      dtype=torch.float32, device="cpu", **kw)
        assert all(torch.equal(p, q) for p, q in
                   zip(a.model.state_dict().values(),
                       b.model.state_dict().values()))
