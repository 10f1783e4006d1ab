"""The port's calibration pass (``tae_tpu_torch.calibrate``) and the
measured-statistics equalization vs the JAX package, on the CPU.

The same weights cross through ``ckpt/bridge`` (or a reference-layout
``.pth``), the same batches go to both sides: the per-channel LayerNorm
amax must agree at fp32 level, and the equalized int8 / int4 codes and
scales built from those statistics as the JAX package builds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.calibrate import ln_amax as j_ln_amax
from tae_tpu.ckpt.torch_export import save_torch_checkpoint
from tae_tpu.ops.int8 import prepare_serving_params as j_prepare_serving
from tae_tpu.tokenizer import Tokenizer as JTokenizer
from tae_tpu.tokenizer import prune_component as j_prune
from tae_tpu_torch import models
from tae_tpu_torch.calibrate import ln_amax, taps
from tae_tpu_torch.ckpt.bridge import (act_amax_from_jax,
                                       serving_state_dict_from_jax,
                                       state_dict_from_jax)
from tae_tpu_torch.ops import int8
from tae_tpu_torch.tokenizer import Tokenizer, prune_component

NAME = "tae_patch16_vocab16_px256"
# 16 tokens of width 256 (the narrowest width int4 takes for every block
# linear), two blocks per half
TINY = dict(img_size=64, embed_dim=256, depth=2, num_heads=4,
            decoder_embed_dim=256, decoder_depth=2, decoder_num_heads=4)
VQ = dict(TINY, quantize=True, codebook_size=64)
# Both sides compute in fp32 on the same (bf16-rounded) weights and differ
# in summation order only: relative to each channel vector's largest value.
STATS_RTOL = 1e-5
# Equalized codes: the equalized float weights are bit-equal on both sides;
# a code may differ by one where the weight lies on a rounding tie (see
# _check_codes), elsewhere at most this share of codes, none by more than
# one.
CODE_SHARE = 1e-3
SCALE_RTOL = 1e-5
TIE = 1e-5


def _jitter_norms(tree, rng):
    """LN affines away from the identity, so equalization has work to do."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            s = np.asarray(tree["scale"])
            return {"scale": jnp.asarray(s * rng.uniform(0.5, 2.0, s.shape)
                                         .astype(np.float32)),
                    "bias": jnp.asarray(rng.normal(0, 0.2, s.shape)
                                        .astype(np.float32))}
        return {k: _jitter_norms(v, rng) for k, v in tree.items()}
    return tree


def _make_pair(kw: dict, tmp_dir):
    """(JAX model, its bf16 params, the port's bf16 model on the same
    weights, the .pth they came from, overrides)."""
    jm = jmodels.create(NAME, **kw)
    params = _jitter_norms(jm.init(jax.random.key(3)),
                           np.random.default_rng(3))
    params = jax.tree.map(np.asarray, params)
    path = tmp_dir / "w.pth"
    save_torch_checkpoint(path, jm, params)
    pb = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), params)
    tm = models.create(NAME, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params, jm.cfg))
    return jm, pb, tm.to(torch.bfloat16).eval(), path, kw


@pytest.fixture(scope="module", params=["plain", "vq"])
def pair(request, tmp_path_factory):
    return _make_pair(TINY if request.param == "plain" else VQ,
                      tmp_path_factory.mktemp("calib"))


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The model without a codebook: a reference .pth holds every weight it
    has (a VQ model's codebook would be each side's own initial one)."""
    return _make_pair(TINY, tmp_path_factory.mktemp("calib_plain"))


def _batches(kind: str, seed: int, cfg, n: int = 2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if kind == "uint8":
            out.append(rng.integers(0, 256, (2, 3, 64, 64), dtype=np.uint8))
        elif kind == "float":
            out.append(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
        elif kind == "patches":
            out.append(rng.integers(0, 256, (2, cfg.num_patches,
                                             3 * cfg.patch_size ** 2),
                                    dtype=np.uint8))
        else:                               # latents for a decoder-only model
            out.append(rng.standard_normal((2, cfg.num_patches,
                                            cfg.vocab_size)).astype(np.float32))
    return out


def _assert_stats_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.shape == w.shape, k
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= STATS_RTOL, (k, err)


@pytest.mark.parametrize("kind", ["uint8", "float", "patches", "latents"])
def test_ln_amax_matches_jax(pair, kind):
    """uint8 and float images, pre-patchified rows, and a decoder-only
    model fed latents (with the VQ model, the decoder's statistics are taken
    behind the bottleneck on both sides)."""
    jm, pb, tm, _, _ = pair
    batches = _batches(kind, 7, jm.cfg)
    if kind == "latents":
        pb = j_prune(pb, "decoder")
        tm = prune_component(_copy(tm), "decoder")
    want = act_amax_from_jax(jax.tree.map(np.asarray,
                                          j_ln_amax(jm, pb, batches)))
    _assert_stats_close(ln_amax(tm, batches), want)


def _copy(tm):
    import copy

    return copy.deepcopy(tm)


def test_ln_amax_keys_are_the_consuming_linears(pair):
    _, _, tm, _, kw = pair
    keys = [k for _, k in taps(tm)]
    depth = kw["depth"]
    assert keys == ([f"{half}.{i}.{lin}"
                     for half in ("blocks", "decoder_blocks")
                     for i in range(depth) for lin in ("attn.qkv", "mlp.fc1")]
                    + ["dict_proj", "decoder_pred"])
    for _, key in taps(tm):
        assert isinstance(tm.get_submodule(key), torch.nn.Module)


def test_ln_amax_margin_and_max_accumulation(pair):
    jm, _, tm, _, _ = pair
    b = _batches("uint8", 9, jm.cfg, n=3)
    each = [ln_amax(tm, [x]) for x in b]
    both = ln_amax(tm, b)
    scaled = ln_amax(tm, b, margin=1.5)
    for k in both:
        assert torch.equal(both[k], torch.stack([e[k] for e in each]).amax(0))
        assert torch.equal(scaled[k], both[k] * 1.5)


def test_ln_amax_needs_a_batch(pair):
    _, _, tm, _, _ = pair
    with pytest.raises(ValueError, match="at least one calibration batch"):
        ln_amax(tm, [])
    with pytest.raises(ValueError, match="at least one calibration batch"):
        ln_amax(tm, iter(()))


def test_act_amax_from_jax_layout(pair):
    jm, pb, _, _, kw = pair
    stats = jax.tree.map(np.asarray, j_ln_amax(jm, pb, _batches("uint8", 1,
                                                                jm.cfg)))
    got = act_amax_from_jax(stats)
    qkv = stats["encoder"]["blocks"]["attn"]["qkv"]["x_amax"]
    assert qkv.shape == (kw["depth"], kw["embed_dim"])
    for i in range(kw["depth"]):
        np.testing.assert_array_equal(got[f"blocks.{i}.attn.qkv"].numpy(),
                                      qkv[i])
    np.testing.assert_array_equal(got["decoder_pred"].numpy(),
                                  stats["decoder"]["pred"]["x_amax"])
    # a pruned half has no entries
    enc_only = act_amax_from_jax({"encoder": stats["encoder"]})
    assert enc_only and all(not k.startswith("decoder") for k in enc_only)


def _codes_and_scales(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if k.endswith((".w_q", ".w_scale", ".w4", ".w4_scale"))}


def _check_codes(got: dict, want: dict, floats: torch.nn.Module) -> None:
    """Scales within SCALE_RTOL; codes never off by more than one, and
    where they differ the float weight lies on a rounding tie of its scale
    (|w / s - (k + 1/2)| < TIE): XLA compiles ``w / s`` as a product with a
    reciprocal, so an exact tie of a bf16 weight (w = s * 3.5, say) goes
    either way. Off the ties at most CODE_SHARE of the codes may differ.
    ``floats`` holds the equalized float weights."""
    from tae_tpu_torch.ops.cuda.int4_matmul import unpack_int4

    assert set(got) == set(want)
    off_tie = total = 0
    for k, w in want.items():
        g = got[k]
        if k.endswith("scale"):
            np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                       rtol=SCALE_RTOL, err_msg=k)
            continue
        name = k.rpartition(".")[0]
        wf = floats.get_submodule(name).weight.float()
        wf = wf.reshape(wf.shape[0], -1)                    # patch embed
        if k.endswith(".w4"):
            g, w = unpack_int4(g), unpack_int4(w)
            sc = got[name + ".w4_scale"].float()
            s = sc.repeat_interleave(wf.shape[1] // sc.shape[0], dim=0).t()
        else:
            s = got[name + ".w_scale"].float()[:, None]
        d = (g.to(torch.int32) - w.to(torch.int32)).abs()
        assert int(d.max()) <= 1, k
        r = wf / s
        tie = (r - r.floor() - 0.5).abs() < TIE
        off_tie += int(((d > 0) & ~tie).sum())
        total += d.numel()
    assert off_tie <= CODE_SHARE * total, (off_tie, total)


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_equalized_codes_match_jax(pair, quantization):
    """Measured statistics -> equalize (alpha 0.5) -> quantize, on both
    sides, from the JAX statistics carried over with act_amax_from_jax."""
    jm, pb, tm, _, _ = pair
    stats = j_ln_amax(jm, pb, _batches("uint8", 5, jm.cfg))
    act = act_amax_from_jax(jax.tree.map(np.asarray, stats))
    jserve = j_prepare_serving(pb, quantization, 0.5, stats)
    want = _codes_and_scales(serving_state_dict_from_jax(
        jax.tree.map(np.asarray, jserve), jm.cfg))
    port = int8.prepare_serving_(_copy(tm), quantization, 0.5, act)
    got = _codes_and_scales(port.state_dict())
    assert any(k.endswith(".w4") for k in got) == (quantization == "int4")
    _check_codes(got, want, int8.equalize_params_(_copy(tm), 0.5, act))


def test_equalize_with_stats_differs_from_affine_estimate(pair):
    """act_amax changes the factors (a stats-free run uses |gamma| + |beta|),
    and stats for only some linears leave the rest on the estimate."""
    jm, _, tm, _, _ = pair
    stats = ln_amax(tm, _batches("uint8", 2, jm.cfg))
    a = int8.equalize_params_(_copy(tm), 0.5)
    b = int8.equalize_params_(_copy(tm), 0.5, stats)
    part = int8.equalize_params_(_copy(tm), 0.5,
                                 {"blocks.0.attn.qkv": stats["blocks.0.attn.qkv"]})
    assert not torch.equal(a.blocks[0].norm1.weight, b.blocks[0].norm1.weight)
    assert torch.equal(part.blocks[0].norm1.weight, b.blocks[0].norm1.weight)
    assert torch.equal(part.blocks[0].norm2.weight, a.blocks[0].norm2.weight)
    assert torch.equal(part.decoder_norm.weight, a.decoder_norm.weight)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tokenizer_calib_images_matches_jax(plain, dtype):
    """``Tokenizer.from_checkpoint(equalize=0.5, calib_images=...)`` on the
    same .pth on both sides: the same int8 codes and scales (JAX's jitted
    weight scales sit one ulp from the eager function's; SCALE_RTOL covers
    it). A code may differ only on a rounding tie (see _check_codes)."""
    jm, _, _, path, kw = plain
    batches = _batches("uint8", 4, jm.cfg)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jtok = JTokenizer.from_checkpoint(NAME, str(path), dtype=jdt,
                                      quantization="int8", equalize=0.5,
                                      calib_images=batches, **kw)
    tok = Tokenizer.from_checkpoint(NAME, str(path), dtype=dtype, device="cpu",
                                    quantization="int8", equalize=0.5,
                                    calib_images=batches, **kw)
    want = _codes_and_scales(serving_state_dict_from_jax(
        jax.tree.map(np.asarray, jtok.params), jm.cfg))
    got = _codes_and_scales(tok.model.state_dict())
    base = Tokenizer.from_checkpoint(NAME, str(path), dtype=dtype,
                                     device="cpu", **kw)
    floats = int8.equalize_params_(base.model, 0.5,
                                   ln_amax(base.model, batches))
    _check_codes(got, want, floats)


def test_tokenizer_calib_images_equals_act_amax(plain):
    """calib_images runs ln_amax on the float model after pruning: the
    same tokenizer as passing those statistics."""
    jm, _, _, path, kw = plain
    batches = _batches("uint8", 6, jm.cfg)
    base = Tokenizer.from_checkpoint(NAME, str(path), device="cpu",
                                     component="encoder", **kw)
    stats = ln_amax(base.model, batches)
    assert all(not k.startswith("decoder") for k in stats)
    a = Tokenizer.from_checkpoint(NAME, str(path), device="cpu",
                                  quantization="int8", component="encoder",
                                  equalize=0.5, calib_images=batches, **kw)
    b = Tokenizer.from_checkpoint(NAME, str(path), device="cpu",
                                  quantization="int8", component="encoder",
                                  equalize=0.5, act_amax=stats, **kw)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # act_amax wins over calib_images, as in the JAX package
    c = Tokenizer.from_checkpoint(NAME, str(path), device="cpu",
                                  quantization="int8", component="encoder",
                                  equalize=0.5, act_amax=stats,
                                  calib_images=[], **kw)
    assert all(torch.equal(c.model.state_dict()[k], sb[k]) for k in sb)


@pytest.mark.parametrize("kwargs, match", [
    (dict(act_amax={}), "require equalize"),
    (dict(calib_images=[]), "require equalize"),
    (dict(act_amax={}, quantization="int8"), "require equalize"),
    # the first check wins where both apply, in the JAX order
    (dict(calib_images=[], quantization=None, equalize=0.0), "require equalize"),
    (dict(equalize=0.5), "only applies to the quantized"),
    (dict(equalize=0.5, act_amax={}), "only applies to the quantized"),
    (dict(equalize=0.5, quantization="fp8"), "only applies to the quantized"),
    (dict(quantization="fp8"), "unknown quantization"),
    (dict(equalize=0.5, quantization="int8", calib_images=[]),
     "at least one calibration batch"),
])
def test_tokenizer_checks_in_jax_order(kwargs, match):
    small = dict(TINY, embed_dim=64, decoder_embed_dim=64)
    with pytest.raises(ValueError, match=match):
        Tokenizer.from_checkpoint(NAME, device="cpu", **kwargs, **small)
    jkw = {k: v for k, v in kwargs.items() if k != "device"}
    if match == "at least one calibration batch":
        return              # JAX raises the same from inside ln_amax
    with pytest.raises(ValueError, match=match if match != "unknown "
                       "quantization" else "quantization"):
        JTokenizer.from_checkpoint(NAME, **jkw, **small)
