"""The selective remat policies of the port (``remat="dots"`` and
``"dots_no_batch"``, ``tae_tpu_torch.nn.vit.REMAT_POLICIES``) against the
JAX package's ``jax.checkpoint`` policies of the same names.

Both sides start from the same numpy parameters (``state_dict_from_jax``)
and see the same numpy batches. The port runs ``backend="reference"``
(plain autograd: the attention's batched products are ATen ``bmm``) and
``backend="kernel"`` (the kernels' ``autograd.Function``s with their plain
versions inside, which the policies recompute as JAX recomputes a
``pallas_call``). A policy changes where a value comes from in the
backward pass, not the value: the port's gradients under either policy
equal its own ``remat=False`` and ``remat=True`` bit for bit.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu_torch import models, profile_training
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.nn import vit
from tae_tpu_torch.train import TrainState, adamw, make_train_step, step_lr
from tae_tpu_torch.train.losses import cross_entropy
from tae_tpu_torch.utils.dtypes import FP32, Policy

# test_torch_train.py's tiny models: 16 tokens (the per-image attention
# entry) and 4 tokens (the tiny-N entry), 2 + 2 blocks
TINY = dict(img_size=64, patch_size=16, embed_dim=64, vocab_size=16, depth=2,
            num_heads=1, decoder_embed_dim=128, decoder_depth=2,
            decoder_num_heads=2)
TINY_N4 = dict(TINY, patch_size=32)
CONFIGS = {"n16": TINY, "n4": TINY_N4}
BLOCKS = TINY["depth"] + TINY["decoder_depth"]
# test_torch_train.py's test_loss_and_gradients_fp32_match_jax: fp32
# gradients through 2 + 2 blocks, sums in another order on each side
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)
LOSS_RTOL = 1e-5
POLICIES = ("dots", "dots_no_batch")
BACKENDS = (None, "kernel")
MM, ADDMM, BMM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.aten.bmm.default)


def _imgs(b=4, seed=42):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 3, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Per config: the JAX model, its numpy parameters, and per policy the
    loss and gradients of ``forward(remat=policy)`` under the FP32 policy
    (made once, shared by both backends)."""
    out = {}
    imgs = jnp.asarray(_imgs())
    for name, kw in CONFIGS.items():
        jm = JTAE(JTAEConfig(**kw))
        params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        grads = {}
        for remat in POLICIES:
            loss, g = jax.value_and_grad(lambda p, r=remat: jm.forward(
                p, imgs, policy=J_FP32, remat=r)[0])(params)
            grads[remat] = (float(loss), state_dict_from_jax(
                jax.tree.map(np.asarray, g), jm.cfg))
        out[name] = (jm, params, grads)
    return out


def _port(jm, params) -> TAE:
    tm = TAE(TAEConfig(**{k: getattr(jm.cfg, k) for k in CONFIGS["n16"]}),
             trainable=True)
    tm.load_state_dict(state_dict_from_jax(params, jm.cfg), strict=True)
    return tm


def _grads(jm, params, remat, backend, policy=FP32):
    tm = _port(jm, params)
    loss, _ = tm(torch.from_numpy(_imgs()), policy=policy, backend=backend,
                 remat=remat)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in tm.named_parameters()}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_policies_match_jax(jax_side, cfg, remat, backend):
    """Loss and every gradient against JAX ``jax.checkpoint`` with the same
    policy name, fp32."""
    jm, params, grads = jax_side[cfg]
    loss_j, want = grads[remat]
    loss, got = _grads(jm, params, remat, backend)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_RTOL)
    assert set(got) == set(want)
    for k in want:
        assert got[k] is not None and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("policy", [FP32, Policy()], ids=["fp32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_policies_equal_plain_and_full_remat(jax_side, cfg, backend, policy):
    """The port's loss and gradients under each policy equal its own
    ``remat=False`` and ``remat=True`` bit for bit; with bf16 compute the
    weight casts are recomputed too."""
    jm, params, _ = jax_side[cfg]
    runs = {r: _grads(jm, params, r, backend, policy)
            for r in (False, True) + POLICIES}
    loss, want = runs[False]
    for remat, (got_loss, got) in runs.items():
        assert got_loss == loss, remat
        for k in want:
            assert torch.equal(got[k], want[k]), (remat, k)


def _logging(monkeypatch):
    """Wrap ``vit.remat_policy`` so that every forward decision of every
    block is noted as (op, decision, grad mode)."""
    log = []
    made = vit.remat_policy

    def logged(saved):
        policy = made(saved)

        def note(ctx, op, *args, **kwargs):
            out = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                log.append((op, out, torch.is_grad_enabled()))
            return out
        return note

    monkeypatch.setattr(vit, "remat_policy", logged)
    return log


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("remat", POLICIES)
def test_the_ops_each_policy_keeps(jax_side, monkeypatch, remat, backend):
    """A logging policy counts what is kept: the 4 linear products a block
    (qkv, proj, fc1, fc2) under both policies; on the reference path 2
    batched products a block more (QKᵀ and PV) under ``"dots"`` only. On
    the kernel path the attention's and LayerNorm's ``autograd.Function``s
    run their plain versions with gradients off, and nothing of them is
    kept, their ``bmm``s included: their outputs are recomputed."""
    log = _logging(monkeypatch)
    jm, params, _ = jax_side["n16"]
    _grads(jm, params, remat, backend)
    kept = collections.Counter(op for op, out, _ in log
                               if out == CheckpointPolicy.MUST_SAVE)
    batched = 2 if backend is None and remat == "dots" else 0
    assert kept == collections.Counter(
        {ADDMM: 4 * BLOCKS, **({BMM: batched * BLOCKS} if batched else {})})
    assert all(out == CheckpointPolicy.PREFER_RECOMPUTE
               for _, out, grad in log if not grad)
    inside = sum(1 for op, _, grad in log if op is BMM and not grad)
    assert inside == (2 * BLOCKS if backend == "kernel" else 0)


def test_a_strided_linear_input_keeps_its_product(monkeypatch):
    """``F.linear`` on a 3-D input reaches ``addmm`` on a flattened view
    where it is contiguous, ``mm`` and an ``add`` where it is not: the
    product is kept either way, and the gradients equal no remat's."""
    log = _logging(monkeypatch)
    lin = vit.Linear(8, 12)
    lin.init_weights_(torch.Generator().manual_seed(0))
    lin.weight.requires_grad_(True)
    lin.bias.requires_grad_(True)
    base = torch.randn(3, 8, 5, generator=torch.Generator().manual_seed(1))
    for x, op in ((base.transpose(1, 2).contiguous(), ADDMM),
                  (base.transpose(1, 2), MM)):
        grads = []
        for remat in (False, "dots"):
            log.clear()
            lin.zero_grad(set_to_none=True)
            ctx = (lambda: create_selective_checkpoint_contexts(
                vit.remat_policy(vit.REMAT_POLICIES["dots"])))
            y = (checkpoint(lin, x, use_reentrant=False, context_fn=ctx)
                 if remat else lin(x))
            y.square().sum().backward()
            grads.append((lin.weight.grad.clone(), lin.bias.grad.clone()))
        kept = [o for o, out, _ in log if out == CheckpointPolicy.MUST_SAVE]
        assert kept == [op]
        assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_an_unknown_policy_raises():
    tm = TAE(TAEConfig(**TINY), trainable=True)
    tm.init_weights_(torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="dots_saveable"):
        tm(torch.from_numpy(_imgs(2)), policy=FP32, remat="dots_saveable")


# ------------------------------------------------------------ other callers

REC = ("vit_recognition_numpatches256_vocab16_base",
       dict(vocab_size=16, decoder_embed_dim=48, decoder_depth=2,
            decoder_num_heads=4, num_classes=7))
SEG = ("vit_segmentation_numpatches256_vocab16_base",
       dict(vocab_size=16, decoder_embed_dim=48, decoder_depth=4,
            decoder_num_heads=4, num_classes=5, patch_size=4))


def _downstream_grads(name, kw, remat, backend):
    tm = models.create(name, trainable=True, **kw)
    tm.init_weights_(torch.Generator().manual_seed(0))
    z = torch.randn(2, 256, 16, generator=torch.Generator().manual_seed(1))
    out = tm(z, policy=Policy(), backend=backend, remat=remat)
    if isinstance(out, dict):   # segmentation: the head and auxiliary head
        (out["out"].float().square().mean()
         + out["aux"].float().abs().mean()).backward()
    else:
        cross_entropy(out, torch.tensor([1, 4])).backward()
    return [p.grad for p in tm.parameters()]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", [REC, SEG], ids=["recognition",
                                                   "segmentation"])
def test_downstream_models_take_the_policies(model, backend):
    """The recognition and segmentation trunks under each policy: gradients
    equal their ``remat=False`` ones bit for bit (bf16 compute)."""
    name, kw = model
    want = _downstream_grads(name, kw, False, backend)
    for remat in POLICIES:
        got = _downstream_grads(name, kw, remat, backend)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), remat


@pytest.mark.parametrize("remat", POLICIES)
def test_train_steps_under_a_policy_equal_no_remat(jax_side, remat):
    """Three ``make_train_step`` steps (AdamW, clipping) under a policy
    against no remat from the same parameters: every metric and parameter
    bit for bit."""
    jm, params, _ = jax_side["n16"]
    states, metrics = [], []
    for r in (False, remat):
        opt = adamw(weight_decay=0.05)
        state = TrainState.create(_port(jm, params), opt)
        step = make_train_step(
            lambda m, b, r=r: (m(b, policy=Policy(), remat=r)[0], {}), opt,
            step_lr(1e-3, 1e-4, 2), clip_grad=0.05)
        got = []
        for it in range(3):
            _, m = step(state, torch.from_numpy(_imgs(seed=it)), it)
            got.append({k: v.clone() for k, v in m.items()})
        states.append(state)
        metrics.append(got)
    for a, b in zip(*metrics):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for p, q in zip(*(s.model.parameters() for s in states)):
        assert torch.equal(p, q)


def test_profile_training_takes_a_policy_name():
    """``profile_training --remat``: absent False, bare True, or a policy's
    name; another name is refused."""
    ap = profile_training.parser()
    assert ap.parse_args([]).remat is False
    assert ap.parse_args(["--remat"]).remat is True
    assert ap.parse_args(["--remat", "--batch", "8"]).remat is True
    for name in POLICIES:
        assert ap.parse_args(["--remat", name]).remat == name
    with pytest.raises(SystemExit):
        ap.parse_args(["--remat", "dots_saveable"])
