"""The codebook search at latents wider than 2048 (the registry's vocab-4096
and -16384 configs, where the kernel tiles z over V) vs the JAX package, on
the CPU: the port's plain version (what the kernel is held to on the card)
against the JAX search in XLA and its Pallas kernel in interpret mode, ids
exactly equal; then discrete tokens of a vocab-4096 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ops import quantizer as jq
from tae_tpu.ops.pallas.quantizer import nearest_code_pallas as j_nearest_pallas
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.ops import quantizer
from tae_tpu_torch.ops.cuda import quantizer as cuda_quantizer
from tae_tpu_torch.tokenizer import Tokenizer
from tae_tpu_torch.utils.dtypes import Policy


@pytest.mark.parametrize("m,k,v", [(64, 300, 4096), (33, 70, 4096),
                                   (16, 130, 16384), (40, 9, 2056)])
def test_nearest_code_wide_latents_match_jax(m, k, v):
    rng = np.random.default_rng(m + v)
    z = rng.standard_normal((m, v)).astype(np.float32)
    cb = rng.standard_normal((k, v)).astype(np.float32)
    got = quantizer.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int64 and tuple(got.shape) == (m,)
    want = np.asarray(jq.nearest_code_xla(jnp.asarray(z), jnp.asarray(cb)))
    assert np.array_equal(got.numpy(), want)
    pallas = j_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), block_m=16,
                              block_k=64, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    # bf16 latents: the codebook rounded to bf16 in both versions
    zb, cbb = torch.from_numpy(z).bfloat16(), torch.from_numpy(cb).bfloat16()
    ids = quantizer.nearest_code(zb, torch.from_numpy(cb))
    want = jq.nearest_code_xla(jnp.asarray(zb.float().numpy()),
                               jnp.asarray(cbb.float().numpy()))
    assert np.array_equal(ids.numpy(), np.asarray(want))
    assert cuda_quantizer.nearest_code.launches == 0


def test_wide_latent_ties_go_to_the_lowest_index():
    """A code repeated across the codebook, and all-equal distances, at a
    width the kernel tiles over V: the lowest index, as in JAX."""
    rng = np.random.default_rng(1)
    cb = rng.standard_normal((200, 4096)).astype(np.float32)
    cb[150], cb[199] = cb[7], cb[7]
    z = np.tile(cb[7], (3, 1))
    assert quantizer.nearest_code(torch.from_numpy(z),
                                  torch.from_numpy(cb)).tolist() == [7] * 3
    assert np.asarray(jq.nearest_code_xla(jnp.asarray(z), jnp.asarray(cb))
                      ).tolist() == [7] * 3
    zero = torch.zeros((200, 4096))
    assert int(quantizer.nearest_code(torch.from_numpy(z), zero).max()) == 0


def test_block_rows_tile_wide_latents():
    """Which bf16 blocks keep z resident in shared memory and which tile it
    over V (the launch plan, ops/cuda/quantizer.vq_plan): every block fits,
    whatever the width."""
    plan = cuda_quantizer.vq_plan
    for v in (4096, 16384):
        assert not any(plan(m, v, 8192, 132).resident for m in (1, 256, 64 * 256))
        assert plan(256, v, 8192, 132).rows == 128
        assert plan(64, v, 8192, 132).rows == 64
        assert plan(64 * 256, v, 8192, 132).smem <= cuda_quantizer.SMEM_LIMIT
    assert plan(16384, 256, 8192, 132).resident
    assert plan(64, 1216, 8192, 132).resident and not plan(
        512, 1216, 8192, 132).resident
    # few row blocks split the codebook into ranges (about one block an SM,
    # at most one range per 128-code tile); enough row blocks do not
    assert plan(256, 256, 8192, 132).splits == 32
    assert plan(16, 256, 8192, 132).splits == 64
    assert plan(16, 256, 100, 132).splits == 1
    assert plan(16384, 256, 8192, 132).splits == 1


def test_vocab_4096_discrete_tokens_match_jax():
    """``quantize=True`` on the p64 vocab-4096 config (cut in width and
    depth): 4096-wide latents through the search, ids equal to the JAX
    tokenizer's."""
    name = "tae_patch64_vocab4096_px256"
    kw = dict(embed_dim=64, depth=1, num_heads=2, decoder_embed_dim=64,
              decoder_depth=1, decoder_num_heads=2, quantize=True,
              codebook_size=48)
    jm = jmodels.create(name, **kw)
    params = jm.init(jax.random.key(5))
    # codes on the latents' scale: rows of a batch's latents plus noise
    x = np.random.default_rng(6).standard_normal((2, 3, 256, 256)).astype(
        np.float32)
    jpol = JPolicy(jnp.float32, jnp.float32)
    z = np.asarray(jm.forward_encoder(params, jnp.asarray(x), policy=jpol))
    assert z.shape == (2, 16, 4096)
    rng = np.random.default_rng(7)
    rows = z.reshape(-1, 4096)[rng.integers(0, 32, 48)]
    cb = rows + 0.1 * z.std() * rng.standard_normal(rows.shape)
    params = dict(params, codebook=jnp.asarray(cb.astype(np.float32)))
    jtok = JTokenizer(model=jm, params=params, policy=jpol)
    tm = models.create(name, **kw)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                           jm.cfg), strict=True)
    tok = Tokenizer(model=tm.eval(), policy=Policy(torch.float32,
                                                   torch.float32))
    ids = tok.encode_discrete(x)
    assert tuple(ids.shape) == (2, 16)
    assert np.array_equal(ids.numpy(), np.asarray(jtok.encode_discrete(x)))
    assert len(np.unique(ids.numpy())) > 3
    rec = tok.decode_discrete(ids)
    np.testing.assert_allclose(rec.numpy(),
                               np.asarray(jtok.decode_discrete(ids.numpy())),
                               atol=2e-5, rtol=1e-4)
