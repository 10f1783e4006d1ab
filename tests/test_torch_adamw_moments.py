"""AdamW with reduced-precision moments (``adamw(moment_dtype=)``): the
port's optimizer (``train.optim.AdamWMoments``) and K18's plain version
(``ops.cuda.adamw``) against the JAX package's ``adamw(moment_dtype=)`` on
a tiny TAE tree; the decay mask, the kernel's table, the state bridge and
a checkpoint round trip. Inputs come from numpy; the JAX tree is taken per
layer, where its decay rule is the port's (test_torch_train says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.train import adamw as j_adamw
from tae_tpu_torch.ckpt import io as ckpt_io
from tae_tpu_torch.ckpt.bridge import (load_adamw_state_from_jax,
                                       state_dict_from_jax)
from tae_tpu_torch.models.tae import TAE, TAEConfig
from tae_tpu_torch.ops.cuda import adamw as k18
from tae_tpu_torch.train import TrainState, adamw, no_decay_mask

TINY = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
            vocab_size=16)
LR, WD, STEPS = 1e-3, 0.05, 3
# fp32 arithmetic in one order on both sides; XLA's pow may differ from
# numpy's by an ulp in the bias corrections. Relative to the parameter, and
# to a millionth of a step where the parameter itself is near 0
PARAM_RTOL = 1e-6
PARAM_ATOL = 1e-6 * LR


def _unstack(params):
    out = {}
    for half, tree in params.items():
        depth = np.asarray(tree["blocks"]["norm1"]["scale"]).shape[0]
        out[half] = dict(tree, blocks=[
            jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
            for i in range(depth)])
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.fixture(scope="module")
def pair():
    jm = JTAE(JTAEConfig(**TINY))
    params = _unstack(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape))
                          .astype(np.float32), params) for _ in range(STEPS)]
    return jm, params, grads


def _port(jm, params, moment_dtype=torch.bfloat16):
    tm = TAE(TAEConfig(**TINY), trainable=True)
    tm.load_state_dict(state_dict_from_jax(params, jm.cfg), strict=True)
    opt = adamw(weight_decay=WD, moment_dtype=moment_dtype)
    return tm, opt, opt.init(tm)


def _set_grads(tm, jm, grads):
    sd = state_dict_from_jax(grads, jm.cfg)
    for name, p in tm.named_parameters():
        p.grad = sd[name].clone()


def test_moments_match_jax_bf16(pair):
    """Three steps from the same parameters and gradients: bf16 moments
    within one bf16 ulp, parameters within 1e-6 relative."""
    jm, params, grads = pair
    opt_j = j_adamw(weight_decay=WD, moment_dtype=jnp.bfloat16)
    state_j, params_j = opt_j.init(params), params
    tm, opt, torch_opt = _port(jm, params)
    for g in grads:
        params_j, state_j = opt_j.update(params_j, state_j, g,
                                         jnp.float32(LR))
        _set_grads(tm, jm, g)
        opt.update(torch_opt, LR)
    want_p = state_dict_from_jax(jax.tree.map(np.asarray, params_j), jm.cfg)
    want_m = state_dict_from_jax(jax.tree.map(np.asarray, state_j.mu), jm.cfg)
    want_v = state_dict_from_jax(jax.tree.map(np.asarray, state_j.nu), jm.cfg)
    assert jax.tree.leaves(state_j.mu)[0].dtype == jnp.bfloat16
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
        state = torch_opt.state[p]
        assert float(state["step"]) == STEPS
        for key, want in (("exp_avg", want_m), ("exp_avg_sq", want_v)):
            got = state[key]
            assert got.dtype == torch.bfloat16
            got, w = got.float().numpy(), want[name].numpy()
            ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(w)))
            assert np.all(np.abs(got - w) <= ulp), (name, key)


def test_decay_mask(pair):
    """The two groups follow ``no_decay_mask``; with zero gradients and
    moments a decayed parameter is scaled by 1 - lr·wd in fp32, an exempt
    one is left alone."""
    jm, params, _ = pair
    tm, opt, torch_opt = _port(jm, params)
    mask = no_decay_mask(tm)
    by_id = {id(p): name for name, p in tm.named_parameters()}
    decayed, exempt = torch_opt.param_groups
    assert decayed["weight_decay"] == WD and exempt["weight_decay"] == 0.0
    assert all(mask[by_id[id(p)]] for p in decayed["params"])
    assert not any(mask[by_id[id(p)]] for p in exempt["params"])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    opt.update(torch_opt, LR)
    factor = np.float32(1.0) - np.float32(LR) * np.float32(WD)
    for name, p in tm.named_parameters():
        want = before[name] * float(factor) if mask[name] else before[name]
        assert torch.equal(p.detach(), want), name


@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float16,
                                          torch.float32])
def test_plain_version_matches_its_formula(moment_dtype):
    """K18's plain version: decay, m, v, p in the JAX order in fp32, the
    moments rounded once to their type."""
    rng = np.random.default_rng(7)
    p0, g, m0, v0 = (rng.standard_normal(37).astype(np.float32)
                     for _ in range(4))
    v0 = np.abs(v0)
    p, gt = torch.from_numpy(p0.copy()), torch.from_numpy(g)
    m = torch.from_numpy(m0).to(moment_dtype)
    v = torch.from_numpy(v0).to(moment_dtype)
    m_in, v_in = m.float().numpy().copy(), v.float().numpy().copy()
    c1, c2 = k18.bias_corrections(0.9, 0.95, 4)
    decay = k18.decay_factor(LR, WD)
    k18.adamw_update([p], [gt], [m], [v], [decay], [LR], [c1], [c2],
                     b1=0.9, b2=0.95, eps=1e-8)
    f = np.float32
    m32 = f(0.9) * m_in + f(1 - 0.9) * g
    v32 = f(0.95) * v_in + f(1 - 0.95) * (g * g)
    want = p0 * f(decay) - (f(LR) * (m32 / f(c1))) / (
        np.sqrt(v32 / f(c2)) + f(1e-8))
    np.testing.assert_array_equal(p.numpy(), want)
    np.testing.assert_array_equal(
        m.float().numpy(),
        torch.from_numpy(m32).to(moment_dtype).float().numpy())
    np.testing.assert_array_equal(
        v.float().numpy(),
        torch.from_numpy(v32).to(moment_dtype).float().numpy())


def test_bias_corrections_and_decay_in_fp32():
    c1, c2 = k18.bias_corrections(0.9, 0.95, 3)
    assert c1 == float(np.float32(1) - np.float32(0.9) ** np.float32(3))
    assert c2 == float(np.float32(1) - np.float32(0.95) ** np.float32(3))
    np.testing.assert_allclose(
        [c1, c2], [1 - 0.9 ** 3, 1 - 0.95 ** 3], rtol=1e-6)
    assert k18.decay_factor(1e-3, 0.0) == 1.0
    assert k18.decay_factor(1e-3, 0.05) == float(np.float32(1) - np.float32(
        1e-3) * np.float32(0.05))


def test_table_rows_and_chunks():
    """The kernel's table: pointers, length, first chunk and the fp32
    scalars of each tensor; empty tensors left out."""
    ts = [torch.zeros(n) for n in (k18.CHUNK + 1, 0, 5, 2 * k18.CHUNK)]
    rows = [(t, t, t, t, 0.5, 1e-3, 0.1, 0.2) for t in ts]
    table, chunks = k18.table(rows)
    assert table.shape == (3, 8) and table.dtype == np.int64
    assert chunks == 2 + 1 + 2
    assert table[:, 4].tolist() == [k18.CHUNK + 1, 5, 2 * k18.CHUNK]
    assert table[:, 5].tolist() == [0, 2, 3]
    assert table[0, 0] == ts[0].data_ptr() and table[2, 3] == ts[3].data_ptr()
    np.testing.assert_array_equal(table.view(np.float32)[:, 12:16],
                                  np.float32([[0.5, 1e-3, 0.1, 0.2]] * 3))


def test_refusals():
    t = torch.zeros(4)
    args = ([0.5], [1e-3], [0.1], [0.2])
    with pytest.raises(TypeError, match="moments"):
        k18.adamw_update([t], [t], [t.to(torch.int8)], [t.to(torch.int8)],
                         *args, b1=0.9, b2=0.95, eps=1e-8)
    with pytest.raises(ValueError, match="gradient"):
        k18.adamw_update([t], [torch.zeros(5)], [t], [t], *args, b1=0.9,
                         b2=0.95, eps=1e-8)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k18.adamw_update([meta], [meta], [meta], [meta], *args, b1=0.9,
                         b2=0.95, eps=1e-8)
    with pytest.raises(TypeError, match="moment_dtype"):
        adamw(moment_dtype=torch.int8)


def test_set_adamw_state_with_bf16_moments(pair):
    """The JAX package's bf16 moments cross through the bridge and stay
    bf16; the next step agrees with the JAX step from the same state."""
    jm, params, grads = pair
    opt_j = j_adamw(weight_decay=WD, moment_dtype=jnp.bfloat16)
    state_j = opt_j.init(params)
    params_j, state_j = opt_j.update(params, state_j, grads[0],
                                     jnp.float32(LR))
    tm, opt, torch_opt = _port(jm, jax.tree.map(np.asarray, params_j))
    load_adamw_state_from_jax(torch_opt, tm, int(state_j.step),
                              jax.tree.map(np.asarray, state_j.mu),
                              jax.tree.map(np.asarray, state_j.nu))
    mu = state_dict_from_jax(jax.tree.map(np.asarray, state_j.mu), jm.cfg)
    for name, p in tm.named_parameters():
        st = torch_opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(st["exp_avg"].float(), mu[name])
    params_j, state_j = opt_j.update(params_j, state_j, grads[1],
                                     jnp.float32(LR))
    _set_grads(tm, jm, grads[1])
    opt.update(torch_opt, LR)
    want = state_dict_from_jax(jax.tree.map(np.asarray, params_j), jm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def test_checkpoint_round_trip_keeps_bf16_moments(pair, tmp_path):
    """Saved after two steps and loaded into a fresh model and optimizer:
    moments bf16 and bit-equal, and the next step equal bit for bit."""
    jm, params, grads = pair
    tm, opt, torch_opt = _port(jm, params)
    for g in grads[:2]:
        _set_grads(tm, jm, g)
        opt.update(torch_opt, LR)
    path = tmp_path / "ck.pt"
    ckpt_io.save_checkpoint(path, TrainState(tm, torch_opt), step=2)
    tm2 = TAE(TAEConfig(**TINY), trainable=True)
    torch_opt2 = opt.init(tm2)
    _, restored, meta = ckpt_io.load_train_state(path, tm2, torch_opt2)
    assert restored and meta["step"] == 2
    for (name, p), q in zip(tm.named_parameters(), tm2.parameters()):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq"):
            a, b = torch_opt.state[p][key], torch_opt2.state[q][key]
            assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    for model, o in ((tm, torch_opt), (tm2, torch_opt2)):
        _set_grads(model, jm, grads[2])
        opt.update(o, LR)
    for p, q in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(p, q)
