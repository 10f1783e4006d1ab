"""The port's qk_norm blocks vs the JAX package's: ``BlockConfig(qk_norm=True)``
adds a LayerNorm over each head's dh columns of q and of k (reference
tae.py:68-69), and the attention runs on the unpacked (B, H, N, dh) operands
(K16 / K17 on the card). No registered model has qk_norm, so the block stack
is driven directly, as ``tae_tpu.nn.vit.blocks_apply`` runs it.

The JAX side runs on the CPU with its XLA attention (its Pallas
``flash_attention`` is held to the port's plain versions in interpret mode in
tests/test_torch_flash_attention.py); the weights cross through
``tae_tpu_torch.ckpt.bridge``. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu.nn import vit as jvit
from tae_tpu.ops.int8 import quantize_params as j_quantize_params
from tae_tpu_torch.ckpt.bridge import blocks_state_dict_from_jax
from tae_tpu_torch.nn import vit
from tae_tpu_torch.ops import int8
from tae_tpu_torch.ops.cuda import flash_attention as fa
from tae_tpu_torch.ops.cuda import layernorm as ln

DIM, HEADS, DEPTH = 128, 2, 2
# fp32 on both sides: the same products summed in another order, through two
# blocks (tests/test_torch_model.py's bound for a whole fp32 model)
FP32 = dict(atol=2e-5, rtol=1e-4)
# gradients of sum(y * w): sums over the batch's 64 rows of O(1) terms
FP32_GRAD = dict(atol=2e-4, rtol=2e-4)
# bf16 compute from the same fp32 parameters: the two packages round at other
# points (casts of each linear's output, the attention's p), relative
# Frobenius error through two blocks (tests/test_torch_model.py's BF16_REL)
BF16_REL = 2e-2
# int8 leaves: both quantize the same fp32 activations per row; a value
# within an ulp of a rounding tie takes the neighbouring code on one side
# (tests/test_torch_int8_model.py's CHAIN_REL, mean-abs relative)
INT8_REL = 5e-3


def _cfg(qk_norm=True):
    return vit.BlockConfig(DIM, HEADS, 4.0, True, qk_norm), \
        jvit.BlockConfig(DIM, HEADS, 4.0, True, qk_norm)


def _jax_blocks(cfg_j, depth=DEPTH, seed=0):
    """Depth-stacked JAX blocks with every LayerNorm affine (q_norm and
    k_norm too) and every bias away from its init, so each one matters."""
    params = jvit.blocks_init(jax.random.key(seed), cfg_j, depth)
    rng = np.random.default_rng(seed)

    def jitter(tree):
        if isinstance(tree, dict) and set(tree) == {"scale", "bias"}:
            s = np.asarray(tree["scale"])
            return {"scale": s * rng.uniform(0.6, 1.5, s.shape).astype(np.float32),
                    "bias": rng.normal(0, 0.2, s.shape).astype(np.float32)}
        if isinstance(tree, dict):
            out = {k: jitter(v) for k, v in tree.items()}
            if "b" in out:
                out["b"] = rng.normal(0, 0.05, np.shape(out["b"])).astype(
                    np.float32)
            return out
        return np.asarray(tree)

    return jitter(jax.tree.map(np.asarray, params))


def _port_blocks(params_np, cfg_t, depth=DEPTH, quantized=False):
    stack = vit.blocks(cfg_t, depth)
    if quantized:
        int8.quantize_params_(stack, fill=False)
    stack.load_state_dict(blocks_state_dict_from_jax(params_np), strict=True)
    return stack


def _x(b, n, seed=5):
    return np.random.default_rng(seed).standard_normal((b, n, DIM)).astype(
        np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_bridge_carries_q_norm_and_k_norm():
    cfg_t, cfg_j = _cfg()
    params = _jax_blocks(cfg_j)
    sd = blocks_state_dict_from_jax(params)
    dh = DIM // HEADS
    for i in range(DEPTH):
        for which in ("q_norm", "k_norm"):
            w = sd[f"{i}.attn.{which}.weight"]
            assert tuple(w.shape) == (dh,)
            assert np.array_equal(w.numpy(), params["attn"][which]["scale"][i])
    stack = _port_blocks(params, cfg_t)
    assert set(stack.state_dict()) == set(sd)
    # a stack without qk_norm has no such keys, and refuses them
    plain = blocks_state_dict_from_jax(_jax_blocks(_cfg(False)[1]))
    assert not any("q_norm" in k for k in plain)
    with pytest.raises(RuntimeError, match="q_norm"):
        vit.blocks(_cfg(False)[0], DEPTH).load_state_dict(sd, strict=True)
    # a list of per-layer trees (the serving layout) bridges the same way
    layers = [jax.tree.map(lambda a, i=i: a[i], params) for i in range(DEPTH)]
    assert all(torch.equal(blocks_state_dict_from_jax(layers)[k], v)
               for k, v in sd.items())


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("n", [16, 4])
def test_qk_norm_stack_forward_and_gradients_match_jax(backend, n):
    """fp32: the stack's output and the gradients of sum(y * w) with respect
    to the input and every parameter (q_norm / k_norm included). The kernel
    backend runs the LayerNorm and attention ``autograd.Function``s with the
    kernels' plain versions in both directions."""
    cfg_t, cfg_j = _cfg()
    params = _jax_blocks(cfg_j, seed=n)
    x = _x(2, n, seed=n)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jvit.blocks_apply(p, xx, cfg_j, backend="xla") * w)

    y_j = jvit.blocks_apply(params, jnp.asarray(x), cfg_j, backend="xla")
    gp_j, gx_j = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    stack = _port_blocks(params, cfg_t).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    y = vit.blocks_apply(stack, tx, backend=backend)
    np.testing.assert_allclose(_np(y), _np(y_j), **FP32)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(gx_j), **FP32_GRAD)
    want = blocks_state_dict_from_jax(jax.tree.map(np.asarray, gp_j))
    got = {k: p.grad for k, p in stack.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        scale = float(np.abs(want[k].numpy()).max())
        np.testing.assert_allclose(_np(g), want[k].numpy(),
                                   atol=FP32_GRAD["atol"] * max(1.0, scale),
                                   rtol=FP32_GRAD["rtol"], err_msg=k)
    assert float(stack[0].attn.q_norm.weight.grad.abs().sum()) > 0
    assert float(stack[1].attn.q_norm.bias.grad.abs().sum()) > 0
    # k_norm's bias moves every score of a query row by one constant, which
    # the softmax ignores: its gradient is zero but for rounding, on both sides
    for i in range(DEPTH):
        kw = float(stack[i].attn.k_norm.weight.grad.norm())
        assert float(stack[i].attn.k_norm.bias.grad.norm()) <= 1e-4 * kw
        assert np.linalg.norm(want[f"{i}.attn.k_norm.bias"].numpy()) <= 1e-4 * kw
    # the CPU leaves every kernel's launch count at zero
    assert fa.flash_attention_fwd_lse.launches == fa.flash_attention_bwd.launches == 0


def test_qk_norm_block_runs_its_norms_and_attention_through_the_kernel_entries():
    """On the kernel backend a qk_norm block's attention is the unpacked
    entry (``FlashAttentionFn`` under autograd) and its four LayerNorms are
    the LayerNorm entry (norm1, norm2 over C; q_norm, k_norm over dh); the
    reference backend is plain autograd. On the CPU both are plain PyTorch
    and agree in the forward to fp32 rounding (the reference attention
    takes torch.softmax, the kernel's plain version exp / rowsum)."""
    cfg_t, cfg_j = _cfg()
    stack = _port_blocks(_jax_blocks(cfg_j), cfg_t).requires_grad_(True)
    x = torch.from_numpy(_x(2, 16)).requires_grad_()
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, y: seen.append(
        (type(y.grad_fn).__name__, tuple(y.shape))))
        for m in (stack[0].norm1, stack[0].attn.q_norm, stack[0].attn.k_norm,
                  stack[0].norm2)]
    y = vit.blocks_apply(stack[:1], x, backend="kernel")
    for h in hooks:
        h.remove()
    assert [s[0] for s in seen] == ["FusedLayerNormFnBackward"] * 4
    assert [s[1] for s in seen] == [(2, 16, DIM), (2, HEADS, 16, 64),
                                    (2, HEADS, 16, 64), (2, 16, DIM)]
    qkv = stack[0].attn.qkv(stack[0].norm1(x))
    r = qkv.reshape(2, 16, 3, HEADS, 64).permute(2, 0, 3, 1, 4)
    o = fa.flash_attention(r[0].contiguous(), r[1].contiguous(), r[2])
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.testing.assert_close(
        y, vit.blocks_apply(stack[:1], x, backend="reference"),
        atol=1e-5, rtol=1e-5)
    assert ln.fused_layer_norm_fwd_stats.launches == 0


def test_qk_norm_stack_in_bf16_matches_jax():
    """bf16 compute from fp32 parameters, as the train path runs it."""
    cfg_t, cfg_j = _cfg()
    params = _jax_blocks(cfg_j, seed=2)
    x = _x(2, 16, seed=3)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    y_j = jvit.blocks_apply(jparams, jnp.asarray(x, jnp.bfloat16), cfg_j,
                            backend="xla")
    stack = _port_blocks(params, cfg_t)
    for backend in ("kernel", "reference"):
        y = vit.blocks_apply(stack.to(torch.bfloat16),
                             torch.from_numpy(x).bfloat16(), backend=backend)
        assert y.dtype == torch.bfloat16
        assert _rel(y, y_j) <= BF16_REL


@pytest.mark.parametrize("serving", [False, True])
def test_qk_norm_block_with_int8_leaves_runs_unfused_as_jax(serving):
    """A qk_norm block whose linears are int8 never takes the fused int8
    path (JAX ``block_apply``'s ``not cfg.qk_norm``): each quantized linear
    dispatches on its own, per-row quantizing its float input, and the
    attention stays float with the exact softmax, whatever ``serving``
    says. Against the JAX block on the same int8 weights (its XLA int8
    path)."""
    cfg_t, cfg_j = _cfg()
    params = _jax_blocks(cfg_j, seed=4)
    qparams = jax.tree.map(np.asarray, j_quantize_params(params))
    assert "w_q" in qparams["mlp"]["fc1"]
    stack = _port_blocks(qparams, cfg_t, quantized=True)
    assert all(isinstance(m, vit.QLinear) for m in (
        stack[0].attn.qkv, stack[0].attn.proj, stack[0].mlp.fc1,
        stack[0].mlp.fc2))
    assert not stack[0].is_int8 and not stack[0].chains_ln
    x = _x(2, 16, seed=6)
    y_j = jvit.blocks_apply(qparams, jnp.asarray(x), cfg_j, backend="xla")
    y = vit.blocks_apply(stack, torch.from_numpy(x), serving=serving)
    got, want = _np(y), _np(y_j)
    rel = float(np.abs(got - want).mean() / np.abs(want).mean())
    assert rel <= INT8_REL, rel
    # the same stack without qk_norm does take the fused path
    plain_t, plain_j = _cfg(False)
    pq = jax.tree.map(np.asarray, j_quantize_params(_jax_blocks(plain_j)))
    assert _port_blocks(pq, plain_t, quantized=True)[0].is_int8


def test_qk_norm_block_refuses_the_qkv_q8_route():
    """The int8-input attention route (``qkv_q8``) is gated off for a
    qk_norm block, as ``use_i8_qkv`` is in the JAX package."""
    cfg_t, cfg_j = _cfg()
    qparams = jax.tree.map(np.asarray, j_quantize_params(_jax_blocks(cfg_j)))
    blk = _port_blocks(qparams, cfg_t, quantized=True)[0]
    blk.attn.qkv_q8 = True
    assert not blk.is_int8
    x = torch.from_numpy(_x(1, 128, seed=9))
    y = blk(x, serving=True)
    blk.attn.qkv_q8 = False
    assert torch.equal(y, blk(x, serving=True))
