"""The port's training path vs the JAX package: model gradients, remat,
AdamW and the schedules, the train step with accumulation and clipping,
checkpoints and resume, positional-embedding interpolation, and the bridge
that carries optimizer state across.

Both sides start from the same numpy parameters (``state_dict_from_jax``)
and see the same numpy batches. JAX differentiates its XLA paths on the CPU
(tests/conftest.py); the port runs ``backend="reference"`` (plain autograd)
and ``backend="kernel"`` (the ``autograd.Function``s with the kernels' plain
versions in both directions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.ckpt.interpolate import interpolate_pos_embed as j_interpolate
from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.train import TrainState as JTrainState
from tae_tpu.train import adamw as j_adamw
from tae_tpu.train import epoch_step_lr as j_epoch_step_lr
from tae_tpu.train import make_train_step as j_make_train_step
from tae_tpu.train import no_decay_mask as j_no_decay_mask
from tae_tpu.train import step_lr as j_step_lr
from tae_tpu.train.step import global_norm as j_global_norm
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt import io as ckpt_io
from tae_tpu_torch.ckpt.bridge import (load_adamw_state_from_jax,
                                       state_dict_from_jax)
from tae_tpu_torch.ckpt.interpolate import interpolate_pos_embed
from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops.int8 import quantize_params_
from tae_tpu_torch.train import (TrainState, adamw, epoch_step_lr,
                                 global_norm, make_eval_step, make_train_step,
                                 no_decay_mask, step_lr)
from tae_tpu_torch.utils.dtypes import FP32, Policy

# 16 tokens (the per-image attention entry) and 4 tokens (the tiny-N entry)
TINY = dict(img_size=64, patch_size=16, embed_dim=64, vocab_size=16, depth=2,
            num_heads=1, decoder_embed_dim=128, decoder_depth=2,
            decoder_num_heads=2)
TINY_N4 = dict(TINY, patch_size=32)
# fp32 gradients through 2 + 2 blocks: sums in another order on each side
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)


def _params(cfg_kw, seed=0):
    jm = JTAE(JTAEConfig(**cfg_kw))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _port(jm, params, **kw):
    tm = TAE(TAEConfig(**{f.name: getattr(jm.cfg, f.name) for f in
                          __import__("dataclasses").fields(TAEConfig)}),
             trainable=True, **kw)
    tm.load_state_dict(state_dict_from_jax(params, jm.cfg), strict=True)
    return tm


def _unstack(params):
    """The JAX tree with each half's depth-stacked blocks as a list of
    per-layer trees. The JAX package's decay rule looks at ``ndim``, and a
    stacked LayerNorm scale (depth, D) or bias (depth, out) has two axes, so
    on its own tree those decay; on per-layer leaves the rule is the
    reference's (and the port's): biases and LayerNorm parameters exempt."""
    out = {}
    for half, tree in params.items():
        depth = np.asarray(tree["blocks"]["norm1"]["scale"]).shape[0]
        out[half] = dict(tree, blocks=[
            jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
            for i in range(depth)])
    return out


def _stack(params):
    """Inverse of :func:`_unstack`, differentiable: what the JAX model takes."""
    return {half: dict(tree, blocks=jax.tree.map(
        lambda *a: jnp.stack(a), *tree["blocks"]))
        for half, tree in params.items()}


def _imgs(b=4, seed=42, size=64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 3, size, size)).astype(np.float32)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-20))


@pytest.fixture(scope="module")
def pair():
    jm, params = _params(TINY)
    return jm, params


# ---------------------------------------------------------------- gradients

@pytest.mark.parametrize("backend", [None, "kernel"])
@pytest.mark.parametrize("cfg_kw", [TINY, TINY_N4], ids=["n16", "n4"])
def test_loss_and_gradients_fp32_match_jax(cfg_kw, backend):
    jm, params = _params(cfg_kw)
    imgs = _imgs()
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jm.forward(p, jnp.asarray(imgs), policy=J_FP32)[0])(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads_j), jm.cfg)
    tm = _port(jm, params)
    loss, _ = tm(torch.from_numpy(imgs), policy=FP32, backend=backend)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert got[k] is not None and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("backend", [None, "kernel"])
def test_gradients_bf16_compute_match_jax(pair, backend):
    """fp32 parameters, bf16 compute (the training policy): gradients come
    back in fp32. Each side rounds activations and their gradients to bf16
    at its own points; over 2 + 2 blocks that measured up to 3e-2 relative
    (Frobenius) per tensor, so 6e-2 bounds it with room and a layout or
    formula fault shows at O(1)."""
    jm, params = pair
    imgs = _imgs()
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jm.forward(p, jnp.asarray(imgs), policy=JPolicy())[0])(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads_j), jm.cfg)
    tm = _port(jm, params)
    loss, pred = tm(torch.from_numpy(imgs), policy=Policy(), backend=backend)
    assert pred.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert abs(float(loss) - float(loss_j)) < 1e-2 * float(loss_j)
    for k, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        assert _rel(p.grad, want[k]) < 6e-2, k


@pytest.mark.parametrize("backend", [None, "kernel"])
def test_remat_gradients_equal_plain(pair, backend):
    jm, params = pair
    imgs = torch.from_numpy(_imgs())
    grads = []
    for remat in (False, True):
        tm = _port(jm, params)
        loss, _ = tm(imgs, policy=FP32, backend=backend, remat=remat)
        loss.backward()
        grads.append((float(loss), [p.grad for p in tm.parameters()]))
    assert grads[0][0] == grads[1][0]
    # the same ops on the same inputs, recomputed: equal bit for bit
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_remat_options_that_have_no_counterpart_raise(pair):
    jm, params = pair
    tm = _port(jm, params)
    imgs = torch.from_numpy(_imgs(2))
    for policy in ("dots", "dots_no_batch"):
        with pytest.raises(NotImplementedError, match="XLA"):
            tm(imgs, policy=FP32, remat=policy)
    quantize_params_(tm)
    assert not any(p.requires_grad for p in tm.parameters())
    with pytest.raises(ValueError, match="int8 block"):
        tm(imgs, policy=FP32, remat=True)
    # an int8 block with a gradient: the first quantizing entry refuses
    x = torch.randn(2, 16, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tm.blocks[0](x)


def test_trainable_flag_and_frozen_models():
    cfg = TAEConfig(**TINY)
    assert all(p.requires_grad for p in TAE(cfg, trainable=True).parameters())
    assert not any(p.requires_grad for p in TAE(cfg).parameters())
    tm = models.create("tae_patch16_vocab16_px256", device="meta",
                       trainable=True, depth=1, decoder_depth=1)
    assert all(p.requires_grad for p in tm.parameters())
    with pytest.raises(ValueError, match="trainable=True"):
        TrainState.create(TAE(cfg), adamw())
    frozen = quantize_params_(TAE(cfg, trainable=True).init_weights_(
        torch.Generator().manual_seed(0)))
    assert isinstance(frozen.blocks[0].mlp.fc1, vit.QLinear)
    with pytest.raises(ValueError, match="trainable=True"):
        TrainState.create(frozen, adamw())


# --------------------------------------------------- optimizer and schedules

def _rand_like_tree(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, params)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_three_steps_match_jax(pair, weight_decay):
    jm, params = pair
    params = _unstack(params)
    j_opt = j_adamw(weight_decay=weight_decay)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_opt.init(j_params)
    tm = _port(jm, params)
    opt = adamw(weight_decay=weight_decay)
    t_opt = opt.init(tm)
    lrs = (1e-3, 1e-3, 5e-4)
    for it, lr in enumerate(lrs):
        grads = _rand_like_tree(params, seed=it)
        j_params, j_state = j_opt.update(j_params, j_state,
                                         jax.tree.map(jnp.asarray, grads),
                                         jnp.float32(lr))
        g_sd = state_dict_from_jax(grads, jm.cfg)
        for k, p in tm.named_parameters():
            p.grad = g_sd[k].clone()
        opt.update(t_opt, lr)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_params), jm.cfg)
    mu = state_dict_from_jax(jax.tree.map(np.asarray, j_state.mu), jm.cfg)
    nu = state_dict_from_jax(jax.tree.map(np.asarray, j_state.nu), jm.cfg)
    start = state_dict_from_jax(params, jm.cfg)
    for k, p in tm.named_parameters():
        # three updates of about lr each: compare the movement, in fp32
        np.testing.assert_allclose((p.detach() - start[k]).numpy(),
                                   (want[k] - start[k]).numpy(),
                                   atol=2e-7, rtol=2e-4, err_msg=k)
        st = t_opt.state[p]
        assert float(st["step"]) == int(j_state.step) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[k].numpy(),
                                   atol=1e-8, rtol=1e-5)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[k].numpy(),
                                   atol=1e-10, rtol=1e-5)


def test_no_decay_mask_matches_jax(pair):
    jm, params = pair
    tm = _port(jm, params)
    got = no_decay_mask(tm)
    # on its own stacked tree the JAX rule lets the blocks' 1-D parameters
    # decay (they carry a depth axis); per layer it is the reference's rule
    assert j_no_decay_mask(params)["encoder"]["blocks"]["norm1"]["scale"]
    params = _unstack(params)
    j_mask = j_no_decay_mask(params)
    # through the bridge: a tree of 1.0 / 0.0 shaped like the parameters
    want = state_dict_from_jax(
        jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32),
                     params, j_mask), jm.cfg)
    assert {k: bool(v.flatten()[0]) for k, v in want.items()} == got
    assert got["pos_embed"] and got["patch_embed.proj.weight"]
    assert not got["norm.weight"] and not got["blocks.0.attn.qkv.bias"]
    groups = adamw(weight_decay=0.05).init(tm).param_groups
    assert [g["weight_decay"] for g in groups] == [0.05, 0.0]
    assert all(p.ndim > 1 for p in groups[0]["params"])
    assert all(p.ndim <= 1 for p in groups[1]["params"])
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        adamw(moment_dtype=torch.bfloat16)


def test_schedules_match_jax():
    s, js = step_lr(1e-4, 1e-5, 450), j_step_lr(1e-4, 1e-5, 450)
    for it in (0, 449, 450, 10 ** 6):
        assert isinstance(s(it), float)
        np.testing.assert_allclose(s(it), float(js(it)), rtol=1e-6)
    e, je = epoch_step_lr(0.1, 30, 0.1), j_epoch_step_lr(0.1, 30, 0.1)
    for epoch in (0, 29, 30, 95):
        np.testing.assert_allclose(e(epoch), float(je(jnp.int32(epoch))),
                                   rtol=1e-6)


def test_global_norm_matches_jax(pair):
    _, params = pair
    want = float(j_global_norm(jax.tree.map(jnp.asarray, params)))
    got = global_norm([torch.from_numpy(a) for a in jax.tree.leaves(params)])
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------- train step

def _loss_fn(policy, **kw):
    return lambda model, batch: (model(batch, policy=policy, **kw)[0], {})


@pytest.mark.parametrize("accum_iter,clip_grad", [(1, None), (2, None),
                                                  (1, 0.05), (2, 0.05)])
def test_three_train_steps_match_jax(pair, accum_iter, clip_grad):
    jm, params = pair
    j_opt = j_adamw(weight_decay=0.05)
    j_step = jax.jit(j_make_train_step(
        lambda p, b: (jm.forward(_stack(p), b, policy=J_FP32)[0], {}), j_opt,
        j_step_lr(1e-3, 1e-4, 2), accum_iter=accum_iter, clip_grad=clip_grad))
    start = state_dict_from_jax(params, jm.cfg)
    j_state = JTrainState.create(
        jax.tree.map(jnp.asarray, _unstack(params)), j_opt)
    tm = _port(jm, params)
    opt = adamw(weight_decay=0.05)
    state = TrainState.create(tm, opt)
    step = make_train_step(_loss_fn(FP32, backend="kernel"), opt,
                           step_lr(1e-3, 1e-4, 2), accum_iter=accum_iter,
                           clip_grad=clip_grad)
    for it in range(3):
        imgs = _imgs(4, seed=it)
        j_state, j_metrics = j_step(j_state, jnp.asarray(imgs), jnp.int32(it))
        state, metrics = step(state, torch.from_numpy(imgs), it)
        assert set(metrics) == {"loss", "lr", "grad_norm"}
        for k, v in metrics.items():
            # device scalars, fetched by the caller: never Python floats
            assert isinstance(v, torch.Tensor) and v.ndim == 0, k
            np.testing.assert_allclose(float(v), float(j_metrics[k]),
                                       rtol=2e-4, err_msg=f"{k} at {it}")
        if clip_grad is not None:
            assert float(metrics["grad_norm"]) > clip_grad   # clipping acts
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params),
                               jm.cfg)
    for k, p in tm.named_parameters():
        # Adam's first steps move every weight by about lr whatever the
        # gradient's size, and m / sqrt(v) amplifies fp32 noise where the
        # gradient is tiny (one element in 50,000 measured 2.7e-5 off):
        # compare the movement with an atol of 5% of lr
        np.testing.assert_allclose((p.detach() - start[k]).numpy(),
                                   (want[k] - start[k]).numpy(),
                                   atol=5e-5, rtol=5e-3, err_msg=k)


def test_accumulation_checks_and_eval_step(pair):
    jm, params = pair
    tm = _port(jm, params)
    opt = adamw()
    step = make_train_step(_loss_fn(FP32), opt, step_lr(1e-3, 1e-4, 9),
                           accum_iter=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(TrainState.create(tm, opt), torch.from_numpy(_imgs(4)), 0)
    out = make_eval_step(_loss_fn(FP32))(tm, torch.from_numpy(_imgs(2)))
    assert out["loss"].grad_fn is None and out["loss"].ndim == 0


# ------------------------------------------------- checkpoints, resume, .pth

def _trained_state(pair, steps=2, **loss_kw):
    jm, params = pair
    tm = _port(jm, params)
    opt = adamw(weight_decay=0.05)
    state = TrainState.create(tm, opt)
    step = make_train_step(_loss_fn(Policy(), **loss_kw), opt,
                           step_lr(1e-3, 1e-4, 100))
    for it in range(steps):
        step(state, torch.from_numpy(_imgs(4, seed=it)), it)
    return state, opt, step


def test_checkpoint_round_trip_and_bit_exact_resume(pair, tmp_path):
    jm, params = pair
    state, opt, step = _trained_state(pair, backend="kernel", remat=True)
    path = tmp_path / "run" / "latest.pt"
    assert ckpt_io.checkpoint_step(path) is None
    ckpt_io.save_checkpoint(path, state, step=2, args={"lr": 1e-3},
                            extra={"best": 0.5})
    assert ckpt_io.checkpoint_step(path) == 2
    assert not list(path.parent.glob("*.tmp"))
    fresh = TrainState.create(_port(jm, _params(TINY, seed=7)[1]), opt)
    model, restored, meta = ckpt_io.load_train_state(path, fresh.model,
                                                     fresh.opt)
    assert restored and meta == {"step": 2, "args": {"lr": 1e-3}, "best": 0.5}
    for (k, a), b in zip(state.model.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k
    batch = torch.from_numpy(_imgs(4, seed=9))
    _, m_run = step(state, batch, 2)
    _, m_new = step(fresh, batch, 2)
    assert float(m_run["loss"]) == float(m_new["loss"])
    assert float(m_run["grad_norm"]) == float(m_new["grad_norm"])
    for (k, a), b in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(a, b), k
    # a second save replaces the first; promote copies it
    ckpt_io.save_checkpoint(path, state, step=3)
    best = tmp_path / "run" / "best.pt"
    ckpt_io.promote_checkpoint(path, best)
    assert ckpt_io.checkpoint_step(best) == 3
    assert ckpt_io.load_checkpoint(best)[1]["step"] == 3


def test_params_only_checkpoint_pth_and_mismatches(pair, tmp_path):
    jm, params = pair
    state, opt, _ = _trained_state(pair, steps=1)
    sd = state.model.state_dict()
    only = tmp_path / "params.pt"
    ckpt_io.save_checkpoint(only, state.model, step=1)
    pth = tmp_path / "reference.pth"
    torch.save({"model": {k: v.clone() for k, v in sd.items()}}, pth)
    bare = tmp_path / "bare.pth"
    torch.save({k: v.clone() for k, v in sd.items()}, bare)
    for path, meta_step in ((only, 1), (pth, None), (bare, None)):
        fresh = TrainState.create(_port(jm, _params(TINY, seed=5)[1]), opt)
        _, restored, meta = ckpt_io.load_train_state(path, fresh.model,
                                                     fresh.opt)
        assert not restored and meta.get("step") == meta_step
        assert all(torch.equal(a, b) for a, b in
                   zip(sd.values(), fresh.model.state_dict().values()))
    with pytest.raises(ValueError, match="not a tae_tpu_torch checkpoint"):
        ckpt_io.load_checkpoint(pth)
    # a file without the decoder keeps the model's own decoder weights
    half = tmp_path / "encoder.pth"
    torch.save({"model": {k: v for k, v in sd.items()
                          if not k.startswith("decoder")}}, half)
    fresh = _port(jm, _params(TINY, seed=5)[1])
    before = fresh.decoder_pred.weight.clone()
    ckpt_io.load_params(half, fresh)
    assert torch.equal(fresh.decoder_pred.weight, before)
    assert torch.equal(fresh.norm.weight, sd["norm.weight"])


def test_interpolate_pos_embed_matches_jax_and_applies_on_load(pair, tmp_path):
    rng = np.random.default_rng(3)
    pos = rng.standard_normal((1, 16, 24)).astype(np.float32)
    for new in (64, 4, 16):
        want = j_interpolate(jnp.asarray(pos), new)
        got = interpolate_pos_embed(torch.from_numpy(pos), new)
        # the same float64 resize matrices, two fp32 einsums on each side
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="square"):
        interpolate_pos_embed(torch.zeros(1, 15, 8), 16)
    # a 64-px checkpoint (16 tokens) loads into the 128-px model (64 tokens)
    jm, params = pair
    small = _port(jm, params)
    path = tmp_path / "small.pt"
    ckpt_io.save_checkpoint(path, small)
    big = TAE(TAEConfig(**dict(TINY, img_size=128)), trainable=True)
    ckpt_io.load_params(path, big)
    assert tuple(big.pos_embed.shape) == (1, 64, 64)
    want = j_interpolate(jnp.asarray(params["encoder"]["pos_embed"]), 64)
    np.testing.assert_allclose(big.pos_embed.detach().numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-5)
    assert torch.equal(big.blocks[1].mlp.fc2.weight, small.blocks[1].mlp.fc2.weight)


def test_optimizer_state_crosses_the_bridge(pair):
    """Both sides start a step from the same non-zero moments: two JAX
    steps, the AdamWState carried over as numpy, then step 3 on both."""
    jm, params = pair
    j_opt = j_adamw(weight_decay=0.05)
    j_step = jax.jit(j_make_train_step(
        lambda p, b: (jm.forward(_stack(p), b, policy=J_FP32)[0], {}), j_opt,
        j_step_lr(1e-3, 1e-4, 100)))
    j_state = JTrainState.create(
        jax.tree.map(jnp.asarray, _unstack(params)), j_opt)
    for it in range(2):
        j_state, _ = j_step(j_state, jnp.asarray(_imgs(4, seed=it)),
                            jnp.int32(it))
    carried = jax.tree.map(np.asarray, j_state.params)
    tm = _port(jm, carried)
    opt = adamw(weight_decay=0.05)
    state = TrainState.create(tm, opt)
    load_adamw_state_from_jax(state.opt, tm, int(j_state.opt.step),
                              jax.tree.map(np.asarray, j_state.opt.mu),
                              jax.tree.map(np.asarray, j_state.opt.nu))
    assert all(float(state.opt.state[p]["step"]) == 2 for p in tm.parameters())
    imgs = _imgs(4, seed=2)
    j_state, j_metrics = j_step(j_state, jnp.asarray(imgs), jnp.int32(2))
    step = make_train_step(_loss_fn(FP32), opt, step_lr(1e-3, 1e-4, 100))
    _, metrics = step(state, torch.from_numpy(imgs), 2)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                               rtol=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), jm.cfg)
    start = state_dict_from_jax(carried, jm.cfg)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose((p.detach() - start[k]).numpy(),
                                   (want[k] - start[k]).numpy(),
                                   atol=5e-5, rtol=5e-3, err_msg=k)
