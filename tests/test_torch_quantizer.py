"""The port's VQ bottleneck vs the JAX package, on the CPU: the codebook
nearest-neighbour search (ids exact), the straight-through estimator with its
losses and gradients, ``TAE.forward(quantize=True)``, discrete tokens through
the ``Tokenizer`` and a train step through the bottleneck.

The JAX side runs its XLA path and its Pallas kernel in interpret mode; the
port runs its plain version, the one the CUDA kernel is held against on the
card. Inputs come from numpy seeds.
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
from tae_tpu_torch.tokenizer import Tokenizer, prune_component
from tae_tpu_torch.train import TrainState, adamw, make_train_step
from tae_tpu_torch.train.optim import no_decay_mask
from tae_tpu_torch.utils.dtypes import Policy

NAME = "tae_patch16_vocab16_px256"
TINY = dict(img_size=64, embed_dim=64, depth=2, num_heads=2,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=2,
            quantize=True, codebook_size=50)
FP32 = Policy(torch.float32, torch.float32, torch.float32)
JFP32 = JPolicy(jnp.float32, jnp.float32)


# ----------------------------------------------------------- nearest codes

@pytest.mark.parametrize("m,k,v,bm,bk", [(32, 64, 16, 8, 16),
                                         (100, 130, 32, 32, 64),
                                         (16, 8192, 256, 16, 512)])
def test_nearest_code_reference_matches_jax_xla_and_pallas(m, k, v, bm, bk):
    """Ids equal, at the shapes tests/test_ops.py holds the JAX kernel to
    (M = 100 and K = 130 are off its blocks)."""
    rng = np.random.default_rng(m + k)
    z = rng.standard_normal((m, v)).astype(np.float32)
    cb = rng.standard_normal((k, v)).astype(np.float32)
    got = quantizer.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int64 and tuple(got.shape) == (m,)
    want = np.asarray(jq.nearest_code_xla(jnp.asarray(z), jnp.asarray(cb)))
    assert np.array_equal(got.numpy(), want)
    pallas = j_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), block_m=bm,
                              block_k=bk, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(pallas))


def test_nearest_code_leading_dims_bf16_and_the_hand_example():
    cb = torch.tensor([[0.0, 0.0], [1.0, 1.0], [-1.0, 0.5]])
    z = torch.tensor([[[0.1, -0.1], [0.9, 1.2], [-0.8, 0.4]]])
    assert quantizer.nearest_code(z, cb).tolist() == [[0, 1, 2]]
    assert quantizer.encode_indices(z, cb).tolist() == [[0, 1, 2]]
    assert torch.equal(quantizer.decode_indices(torch.tensor([[2, 0]]), cb),
                       cb[[2, 0]][None])
    rng = np.random.default_rng(1)
    zb = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32))
    cbb = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32))
    ids = quantizer.nearest_code(zb.bfloat16(), cbb.bfloat16())
    assert tuple(ids.shape) == (2, 7)
    want = jq.nearest_code_xla(jnp.asarray(zb.bfloat16().float().numpy()),
                               jnp.asarray(cbb.bfloat16().float().numpy()))
    assert np.array_equal(ids.numpy(), np.asarray(want))


def test_an_exact_tie_goes_to_the_lowest_index():
    rng = np.random.default_rng(2)
    cb = rng.standard_normal((300, 16)).astype(np.float32)
    cb[77] = cb[5]
    cb[290] = cb[5]
    z = np.tile(cb[5], (4, 1))
    ids = quantizer.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert ids.tolist() == [5, 5, 5, 5]
    for fn in (lambda a, b: jq.nearest_code_xla(a, b),
               lambda a, b: j_nearest_pallas(a, b, block_m=4, block_k=64,
                                             interpret=True)):
        assert np.asarray(fn(jnp.asarray(z), jnp.asarray(cb))).tolist() == [5] * 4
    # every distance equal: index 0
    zero = torch.zeros((9, 16))
    assert int(quantizer.nearest_code(torch.from_numpy(z), zero).max()) == 0


def test_nearest_code_dispatch_on_the_cpu():
    """A CPU tensor takes the plain version whatever the width; the kernel's
    wrapper does too, and counts no launch; ``backend="kernel"`` on a CPU
    tensor is still the plain version (the wrapper decides by device)."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((6, 24)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((11, 24)).astype(np.float32))
    want = cuda_quantizer.nearest_code_reference(z, cb)
    for backend in (None, "reference", "kernel"):
        assert torch.equal(quantizer.nearest_code(z, cb, backend), want)
    assert torch.equal(cuda_quantizer.nearest_code(z, cb), want)
    assert cuda_quantizer.nearest_code.launches == 0
    # which bf16 blocks keep z resident, and which tile it over V (the
    # launch plan: 64 rows a block up to 64 rows, 128 above)
    plan = cuda_quantizer.vq_plan
    assert plan(64, 1216, 8192, 132).resident and not plan(
        64, 1224, 8192, 132).resident and not plan(64, 4096, 8192, 132).resident
    assert plan(65536, 4096, 8192, 132).rows == 128
    assert plan(16384, 4096, 8192, 132).rows == 128
    assert plan(64, 4096, 8192, 132).rows == 64
    wide = torch.from_numpy(rng.standard_normal((3, 2056)).astype(np.float32))
    assert tuple(quantizer.nearest_code(wide, wide).shape) == (3,)
    with pytest.raises(ValueError, match="unknown backend"):
        quantizer.nearest_code(z, cb, backend="pallas")
    with pytest.raises(ValueError, match=r"\(M, V\)"):
        cuda_quantizer.nearest_code(z[None], cb)


def test_wide_latents_raise_on_a_cuda_tensor():
    """V > 2048 raises nothing for its width: the kernel tiles z over V, so
    the dispatcher hands a wide latent of any device but the CPU to the
    kernel's wrapper, which raises only for what no kernel takes (here a
    tensor on the meta device; the card tests hold real CUDA tensors to the
    kernel at V = 4096 and 16384)."""
    for v in (4096, 2056, 16384):
        z = torch.empty((3, v), device="meta")
        with pytest.raises(ValueError, match="CPU or CUDA"):
            quantizer.nearest_code(z, torch.empty((5, v), device="meta"),
                                   backend="kernel")
    # the registered V = 4096 configs search on the CPU as before
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.standard_normal((5, 4096)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((12, 4096)).astype(np.float32))
    want = np.asarray(jq.nearest_code_xla(jnp.asarray(z.numpy()),
                                          jnp.asarray(cb.numpy())))
    for backend in (None, "reference", "kernel"):
        assert np.array_equal(quantizer.nearest_code(z, cb, backend).numpy(),
                              want)
    assert cuda_quantizer.nearest_code.launches == 0


def test_the_search_runs_in_the_latents_dtype():
    """bf16 latents against an fp32 codebook (a train step with fp32
    parameters): the codebook is rounded to bf16 first, in the plain version
    as in the kernel, so the ids are exactly those of the rounded codebook
    (and of the JAX search on it); fp32 latents leave the codebook alone."""
    rng = np.random.default_rng(9)
    z = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((500, 32)).astype(np.float32))
    zb, cbb = z.bfloat16(), cb.bfloat16()
    ids = quantizer.nearest_code(zb, cb)
    assert torch.equal(ids, quantizer.nearest_code(zb, cbb))
    assert torch.equal(ids, cuda_quantizer.nearest_code(zb, cb))
    want = jq.nearest_code_xla(jnp.asarray(zb.float().numpy()),
                               jnp.asarray(cbb.float().numpy()))
    assert np.array_equal(ids.numpy(), np.asarray(want))
    assert torch.equal(quantizer.nearest_code(z, cb),
                       cuda_quantizer.nearest_code_reference(z, cb.double()))


def test_nearest_code_does_not_trip_on_gradients():
    """It returns ids and has no gradient: training calls it under the
    straight-through estimator on a z that requires one."""
    z = torch.randn((5, 8), requires_grad=True)
    cb = torch.randn((7, 8), requires_grad=True)
    for fn in (quantizer.nearest_code, cuda_quantizer.nearest_code,
               cuda_quantizer.nearest_code_reference):
        ids = fn(z, cb)
        assert ids.dtype == torch.int64 and not ids.requires_grad


# ------------------------------------------------------------------ vq_ste

def _ste_case(seed=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, 3, 4)).astype(dtype)
    cb = rng.standard_normal((8, 4)).astype(dtype)
    w = rng.standard_normal((2, 3, 4)).astype(dtype)
    return z, cb, w


@pytest.mark.parametrize("beta", [0.25, 1.0])
def test_vq_ste_value_loss_and_gradients_match_jax(beta):
    """fp32 on both sides: values and the auxiliary loss to 1e-6, gradients
    of ``sum(z_q * w) + aux`` with respect to z and the codebook to 1e-6."""
    z, cb, w = _ste_case()

    def f(zj, cbj):
        zq, aux = jq.vq_ste(zj, cbj, beta)
        return jnp.sum(zq * w) + aux, (zq, aux)

    (_, (zq_j, aux_j)), (gz_j, gcb_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))
    tz = torch.from_numpy(z).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    zq, aux = quantizer.vq_ste(tz, tcb, beta)
    np.testing.assert_allclose(zq.detach().numpy(), np.asarray(zq_j),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=1e-6)
    ((zq * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz_j), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(gcb_j), atol=1e-6,
                               rtol=1e-5)
    assert float(tcb.grad.abs().sum()) > 0
    # the forward value is the codes' own rows
    ids = quantizer.nearest_code(tz, tcb)
    np.testing.assert_allclose(zq.detach().numpy(), cb[ids.numpy()], atol=1e-6)


def test_vq_ste_gradient_is_identity_to_the_encoder():
    z, cb, _ = _ste_case(5)
    tz = torch.from_numpy(z).requires_grad_()
    zq, _ = quantizer.vq_ste(tz, torch.from_numpy(cb))
    (zq * 2.0).sum().backward()
    np.testing.assert_allclose(tz.grad.numpy(), 2.0 * np.ones_like(z),
                               atol=1e-6)
    # bf16 latents against an fp32 codebook (the training layout): the
    # output keeps z's dtype and both get a gradient
    tz = torch.from_numpy(z).bfloat16().requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    zq, aux = quantizer.vq_ste(tz, tcb)
    assert zq.dtype == torch.bfloat16 and aux.dtype == torch.float32
    (zq.float().sum() + aux).backward()
    assert tz.grad is not None and tcb.grad is not None


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def vq_pair():
    """(JAX model, its parameters with a codebook on the latents' scale, the
    port's model holding the same weights)."""
    jm = jmodels.create(NAME, **TINY)
    params = jm.init(jax.random.key(7))
    cb = np.random.default_rng(6).standard_normal((50, 16)).astype(np.float32)
    params = dict(params, codebook=jnp.asarray(cb * 0.5))
    tm = models.create(NAME, trainable=True, **TINY)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                           jm.cfg), strict=True)
    return jm, params, tm


def test_state_dict_from_jax_carries_the_codebook(vq_pair):
    jm, params, tm = vq_pair
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), jm.cfg)
    assert "codebook" in sd and tuple(sd["codebook"].shape) == (50, 16)
    assert np.array_equal(tm.codebook.detach().numpy(),
                          np.asarray(params["codebook"]))
    plain = {k: v for k, v in params.items() if k != "codebook"}
    assert "codebook" not in state_dict_from_jax(
        jax.tree.map(np.asarray, plain), jm.cfg)


def test_quantized_forward_loss_and_gradients_match_jax(vq_pair):
    """``TAE.forward(quantize=True)`` in fp32 on bridged weights: the loss
    (reconstruction + codebook + beta * commitment) to 1e-5, the prediction
    to the float model's tolerance, the codebook's gradient to 1e-5 of its
    largest entry."""
    jm, params, tm = vq_pair
    imgs = np.random.default_rng(8).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)

    def loss_j(p):
        return jm.forward(p, jnp.asarray(imgs), policy=JFP32, backend="xla")[0]

    loss_jax, grads = jax.value_and_grad(loss_j)(params)
    _, pred_j = jm.forward(params, jnp.asarray(imgs), policy=JFP32,
                           backend="xla")
    tm.zero_grad()
    loss, pred = tm(torch.from_numpy(imgs), policy=FP32)
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-5)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j),
                               atol=2e-5, rtol=1e-4)
    loss.backward()
    g, gj = tm.codebook.grad.numpy(), np.asarray(grads["codebook"])
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(g, gj, atol=1e-5 * np.abs(gj).max(), rtol=1e-4)
    # the encoder is reached through the straight-through estimator
    ge = tm.dict_proj.weight.grad.numpy().T
    gej = np.asarray(grads["encoder"]["dict_proj"]["w"])
    np.testing.assert_allclose(ge, gej, atol=1e-5 * np.abs(gej).max(),
                               rtol=1e-3)
    # the continuous model's loss differs: the bottleneck is on the path
    loss_c = tm.forward_loss(torch.from_numpy(imgs), tm.forward_decoder(
        tm.forward_encoder(torch.from_numpy(imgs), policy=FP32), policy=FP32))
    assert abs(float(loss_c) - float(loss)) > 1e-4


def test_codebook_parameter_init_and_pruning():
    tm = models.create(NAME, **TINY)
    tm.init_weights_(torch.Generator().manual_seed(0))
    cb = tm.codebook
    assert tuple(cb.shape) == (50, 16) and not cb.requires_grad
    assert float(cb.abs().max()) <= 1.0 / 50 and float(cb.std()) > 0.2 / 50
    assert abs(float(cb.mean())) < 0.2 / 50
    # the same seed gives the continuous model the same weights
    plain = models.create(NAME, **dict(TINY, quantize=False))
    plain.init_weights_(torch.Generator().manual_seed(0))
    assert not hasattr(plain, "codebook")
    assert torch.equal(plain.dict_proj.weight, tm.dict_proj.weight)
    assert torch.equal(plain.decoder_pos_embed, tm.decoder_pos_embed)
    # both halves share the codebook: pruning keeps it
    for component in ("encoder", "decoder"):
        half = models.create(NAME, **TINY)
        assert hasattr(prune_component(half, component), "codebook")
    # a 2-D leaf: it decays, by the ndim rule
    assert no_decay_mask(tm)["codebook"] is True
    assert models.create(NAME, trainable=True, **TINY).codebook.requires_grad


# --------------------------------------------------------------- tokenizer

@pytest.fixture(scope="module")
def vq_tokenizers(tmp_path_factory, vq_pair):
    jm, params, _ = vq_pair
    jtok = JTokenizer(model=jm, params=params, policy=JFP32)
    path = tmp_path_factory.mktemp("ckpt") / "vq.pth"
    torch.save(state_dict_from_jax(jax.tree.map(np.asarray, params), jm.cfg),
               path)
    tok = Tokenizer.from_checkpoint(NAME, ckpt=str(path), dtype=torch.float32,
                                    device="cpu", **TINY)
    return jtok, tok


def test_discrete_tokens_match_the_jax_tokenizer(vq_tokenizers):
    jtok, tok = vq_tokenizers
    x = np.random.default_rng(9).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    ids_j = np.asarray(jtok.encode_discrete(x))
    ids = tok.encode_discrete(x)
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (2, 16)
    assert np.array_equal(ids.numpy(), ids_j)
    assert len(np.unique(ids_j)) > 3
    # latents in place of images
    z = tok.encode(x)
    assert torch.equal(tok.encode_discrete(z), ids)
    rec_j = np.asarray(jtok.decode_discrete(ids_j))
    rec = tok.decode_discrete(ids)
    assert tuple(rec.shape) == (2, 3, 64, 64)
    np.testing.assert_allclose(rec.numpy(), rec_j, atol=2e-5, rtol=1e-4)
    assert torch.equal(rec, tok.decode(tok.model.codebook[ids]))
    assert torch.equal(tok.decode_discrete(ids.numpy()), rec)


def test_discrete_tokens_need_a_codebook_and_keep_it_when_pruned(vq_tokenizers):
    _, tok = vq_tokenizers
    plain = Tokenizer.from_checkpoint(NAME, device="cpu",
                                      **dict(TINY, quantize=False))
    x = np.zeros((1, 3, 64, 64), np.float32)
    with pytest.raises(ValueError, match="quantize=True"):
        plain.encode_discrete(x)
    with pytest.raises(ValueError, match="quantize=True"):
        plain.decode_discrete(np.zeros((1, 16), np.int64))
    dec = Tokenizer.from_checkpoint(NAME, device="cpu", component="decoder",
                                    **TINY)
    assert tuple(dec.decode_discrete(np.zeros((1, 16), np.int64)).shape) == \
        (1, 3, 64, 64)
    with pytest.raises(ValueError, match="encoder was pruned"):
        dec.encode_discrete(x)
    # latents need no encoder
    assert tuple(dec.encode_discrete(np.zeros((1, 16, 16), np.float32)).shape) \
        == (1, 16)


def test_vq_serving_artifact_round_trip(vq_tokenizers, tmp_path):
    _, tok = vq_tokenizers
    tok.save_serving(tmp_path / "vq.pt")
    back = Tokenizer.from_serving(NAME, tmp_path / "vq.pt", device="cpu",
                                  **TINY)
    x = np.random.default_rng(10).standard_normal((1, 3, 64, 64)).astype(
        np.float32)
    ids = tok.encode_discrete(x)
    assert torch.equal(back.encode_discrete(x), ids)
    assert torch.equal(back.decode_discrete(ids), tok.decode_discrete(ids))


# ---------------------------------------------------------------- training

def test_train_step_through_the_bottleneck(vq_pair):
    """``make_train_step`` unchanged: the codebook is one more parameter (in
    the decayed group, a 2-D leaf), gets a gradient and moves."""
    _, _, tm = vq_pair
    model = models.create(NAME, trainable=True, **TINY)
    model.load_state_dict(tm.state_dict())
    opt = adamw(weight_decay=0.05)
    state = TrainState.create(model, opt)
    decayed = {id(p) for p in state.opt.param_groups[0]["params"]} \
        if state.opt.param_groups[0]["weight_decay"] else \
        {id(p) for p in state.opt.param_groups[1]["params"]}
    assert id(model.codebook) in decayed

    def loss_fn(m, batch):
        return m(batch, policy=FP32)[0], {}

    step = make_train_step(loss_fn, opt, lambda it: 1e-3)
    batch = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (4, 3, 64, 64)).astype(np.float32))
    before = model.codebook.detach().clone()
    _, metrics = step(state, batch, 0)
    assert np.isfinite(float(metrics["loss"]))
    assert float(model.codebook.grad.abs().sum()) > 0
    assert not torch.equal(model.codebook.detach(), before)
    assert cuda_quantizer.nearest_code.launches == 0
