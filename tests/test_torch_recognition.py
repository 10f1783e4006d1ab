"""The port's recognition ViT, losses and recognition augmentations against
the JAX package's, on the CPU.

The JAX model's parameters (numpy, from ``model.init``) reach the port
through ``ckpt.bridge.recognition_state_dict_from_jax``; both sides run the
same numpy latents (JAX: XLA on the CPU, as its own tests run it; port: the
plain PyTorch versions, and with ``backend="kernel"`` the kernels' autograd
functions on their plain versions). Two token counts: 256 (the per-image
attention entry, K2 / K10 on the card) and 4 (the tiny-N entry, K6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tae_tpu import models as jmodels
from tae_tpu.ckpt.torch_export import save_torch_checkpoint
from tae_tpu.data import mixup as jmixup
from tae_tpu.data import randaugment as jra
from tae_tpu.train import losses as jlosses
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu.utils.dtypes import Policy as JPolicy
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import recognition_state_dict_from_jax
from tae_tpu_torch.ckpt.io import load_params
from tae_tpu_torch.data import mixup, randaugment
from tae_tpu_torch.train import losses
from tae_tpu_torch.utils.dtypes import FP32, Policy

TINY = dict(vocab_size=16, decoder_embed_dim=48, decoder_depth=2,
            decoder_num_heads=4)
# 256 tokens (per-image attention) and 4 tokens (the tiny-N entry)
CONFIGS = {"n256": "vit_recognition_numpatches256_vocab16_base",
           "n4": "vit_recognition_numpatches4_vocab1024_base"}
CLASSES = 7
# fp32 forward, relative (Frobenius): the same ops summed in other orders
FP32_REL = 1e-5
# bf16 compute: each side rounds matmul outputs, bias adds, GELU and the
# residual to bf16 at its own points (tests/test_torch_model.py's bound)
BF16_REL = 2e-2
# fp32 gradients of one step, relative (Frobenius) per tensor
GRAD_REL = 1e-4
# the losses in fp32 on the same logits
LOSS_TOL = 1e-6


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - w)
                 / max(np.linalg.norm(w), 1e-30))


def _pair(name, num_classes=CLASSES, seed=0, trainable=False):
    jm = jmodels.create(name, num_classes=num_classes, **TINY)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tm = models.create(name, num_classes=num_classes, trainable=trainable,
                       **TINY)
    tm.load_state_dict(recognition_state_dict_from_jax(params, jm.cfg),
                       strict=True)
    return jm, params, tm


def _latents(jm, b=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, jm.cfg.num_patches, jm.cfg.vocab_size)
                               ).astype(np.float32)


# ------------------------------------------------------------------- model

@pytest.mark.parametrize("backend", [None, "kernel"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_forward_matches_jax(cfg, policy, backend):
    jm, params, tm = _pair(CONFIGS[cfg])
    z = _latents(jm)
    jpol, pol, tol = ((J_FP32, FP32, FP32_REL) if policy == "fp32"
                      else (JPolicy(), Policy(), BF16_REL))
    want = jm.forward(params, jnp.asarray(z), policy=jpol)
    with torch.no_grad():
        got = tm(torch.from_numpy(z), policy=pol, backend=backend)
    assert got.shape == (3, CLASSES)
    assert got.dtype == (torch.float32 if policy == "fp32" else torch.bfloat16)
    assert _rel(got, jnp.asarray(want, jnp.float32)) < tol


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_feature_extractor_matches_jax(cfg):
    """num_classes=None: no head, the pooled (B, D) features."""
    jm, params, tm = _pair(CONFIGS[cfg], num_classes=None)
    assert not hasattr(tm, "head") and "head" not in params
    z = _latents(jm)
    want = jm.forward(params, jnp.asarray(z), policy=J_FP32)
    with torch.no_grad():
        got = tm(torch.from_numpy(z), policy=FP32)
        feats = tm.forward_features(torch.from_numpy(z), policy=FP32)
    assert got.shape == (3, 48) and feats.shape == (3, jm.cfg.num_patches, 48)
    assert _rel(got, want) < FP32_REL


@pytest.mark.parametrize("backend", [None, "kernel"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_train_step_gradients_match_jax(cfg, backend):
    """The loss of a train step (cross-entropy of the logits) and every
    parameter's gradient against jax.grad of the JAX loss, fp32."""
    jm, params, tm = _pair(CONFIGS[cfg], trainable=True)
    z = _latents(jm, b=4)
    t = np.random.default_rng(2).integers(0, CLASSES, 4)

    def jloss(p):
        return jlosses.cross_entropy(
            jm.forward(p, jnp.asarray(z), policy=J_FP32), jnp.asarray(t))

    loss_j, grads_j = jax.value_and_grad(jloss)(params)
    want = recognition_state_dict_from_jax(jax.tree.map(np.asarray, grads_j))
    loss = losses.cross_entropy(
        tm(torch.from_numpy(z), policy=FP32, backend=backend),
        torch.from_numpy(t))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= FP32_REL * abs(float(loss_j))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert _rel(p.grad, want[k].numpy()) < GRAD_REL, k


def test_remat_gradients_equal_plain():
    jm, params, _ = _pair(CONFIGS["n256"])
    z = torch.from_numpy(_latents(jm))
    t = torch.tensor([0, 3, 6])
    grads = []
    for remat in (False, True):
        _, _, tm = _pair(CONFIGS["n256"], trainable=True)
        losses.cross_entropy(tm(z, policy=FP32, remat=remat), t).backward()
        grads.append([p.grad for p in tm.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_replace_head_keeps_the_trunk():
    jm, params, tm = _pair(CONFIGS["n256"], trainable=True)
    trunk = {k: v.clone() for k, v in tm.state_dict().items()
             if not k.startswith("head.")}
    tm.replace_head(3, torch.Generator().manual_seed(5))
    jm3, jp3 = jm.replace_head(params, jax.random.key(5), 3)
    assert tm.cfg.num_classes == jm3.cfg.num_classes == 3
    assert tuple(tm.head.weight.shape) == (3, 48)
    assert np.asarray(jp3["head"]["w"]).shape == (48, 3)
    assert tm.head.weight.requires_grad and tm.head.bias.requires_grad
    assert float(tm.head.bias.detach().abs().max()) == 0.0
    bound = (6.0 / (48 + 3)) ** 0.5           # xavier-uniform
    w = tm.head.weight.detach()
    assert 0 < float(w.abs().max()) <= bound and float(w.std()) > bound / 4
    sd = tm.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in trunk.items())
    # the same head from the same generator; another seed, another head
    again = models.create(CONFIGS["n256"], num_classes=CLASSES, **TINY)
    again.replace_head(3, torch.Generator().manual_seed(5))
    assert torch.equal(again.head.weight, tm.head.weight)
    again.replace_head(3, torch.Generator().manual_seed(6))
    assert not torch.equal(again.head.weight, tm.head.weight)
    assert tm(torch.from_numpy(_latents(jm)), policy=FP32).shape == (3, 3)


def test_reference_state_dict_loads_through_load_params(tmp_path):
    """A reference-layout .pth (the JAX package's export, the keys
    ckpt/torch_import.py reads) loads into the port through
    ckpt/io.load_params; the port's own keys are the reference's."""
    from tae_tpu.ckpt.torch_export import recognition_state_dict

    jm, params, _ = _pair(CONFIGS["n256"])
    save_torch_checkpoint(tmp_path / "cls.pth", jm, params)
    tm = models.create(CONFIGS["n256"], num_classes=CLASSES, **TINY)
    tm.init_weights_(torch.Generator().manual_seed(0))
    load_params(tmp_path / "cls.pth", tm)
    want = recognition_state_dict_from_jax(params)
    ref_keys = set(recognition_state_dict(params, jm.cfg))
    assert set(tm.state_dict()) == set(want) == ref_keys
    assert all(torch.equal(tm.state_dict()[k], want[k]) for k in want)


def test_registry_matches_jax():
    names = models.list_models("vit_recognition")
    assert names == jmodels.list_models("vit_recognition") and len(names) == 12
    for name in names:
        cfg = models.create(name, device="meta").cfg
        jcfg = jmodels.create(name).cfg
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
    # full width: ViT-Base trunk, the 19167-class in19k head
    tm = models.create("vit_recognition_numpatches256_vocab256_base",
                       num_classes=19167, device="meta")
    jm = jmodels.create("vit_recognition_numpatches256_vocab256_base",
                        num_classes=19167)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tm.cfg.decoder_num_heads == 12 and tm.cfg.decoder_embed_dim == 768


def test_trainable_flag():
    tm = models.create(CONFIGS["n4"], num_classes=3, **TINY)
    assert not any(p.requires_grad for p in tm.parameters())
    tm = models.create(CONFIGS["n4"], num_classes=3, trainable=True, **TINY)
    assert all(p.requires_grad for p in tm.parameters())


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["int", "soft"])
def test_cross_entropy_matches_jax(kind, smoothing):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((6, 11))).astype(np.float32)
    if kind == "int":
        targets = rng.integers(0, 11, 6)
    else:
        targets = rng.dirichlet(np.ones(11), 6).astype(np.float32)
    want = float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                       label_smoothing=smoothing))
    got = losses.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(targets),
                               label_smoothing=smoothing)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= LOSS_TOL * abs(want)
    # and torch's own cross-entropy, which the reference calls
    ref = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        label_smoothing=smoothing)
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)


def test_cross_entropy_of_bf16_logits_is_fp32():
    logits = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    got = losses.cross_entropy(logits.bfloat16(), torch.tensor([0, 1, 2, 4]))
    want = losses.cross_entropy(logits.bfloat16().float(),
                                torch.tensor([0, 1, 2, 4]))
    assert got.dtype == torch.float32 and float(got) == float(want)


@pytest.mark.parametrize("c", [3, 5, 11])
@pytest.mark.parametrize("kind", ["int", "soft"])
def test_topk_accuracy_matches_jax(c, kind):
    """k clamps to the class count (torch.topk would raise at k > C); soft
    targets score against their argmax."""
    rng = np.random.default_rng(c)
    logits = rng.standard_normal((16, c)).astype(np.float32)
    targets = (rng.integers(0, c, 16) if kind == "int"
               else rng.dirichlet(np.ones(c), 16).astype(np.float32))
    want = jlosses.topk_accuracy(jnp.asarray(logits), jnp.asarray(targets),
                                 ks=(1, 2, 5))
    got = losses.topk_accuracy(torch.from_numpy(logits),
                               torch.from_numpy(targets), ks=(1, 2, 5))
    assert set(got) == set(want) == {"acc1", "acc2", "acc5"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL * 100, k
    if c <= 5:
        assert float(got["acc5"]) == 100.0


# ------------------------------------------------------------ augmentation

@pytest.mark.parametrize("seed", range(4))
def test_mixup_cutmix_and_collate_bit_equal(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((5, 3, 12, 10)).astype(np.float32)
    targets = rng.integers(0, 7, 5)
    for fn, alpha in (("mixup", 0.2), ("cutmix", 1.0)):
        a = getattr(mixup, fn)(imgs, targets, 7, alpha,
                               np.random.default_rng(seed + 10))
        b = getattr(jmixup, fn)(imgs, targets, 7, alpha,
                                np.random.default_rng(seed + 10))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    ours = mixup.mixup_cutmix_collate(7, seed=seed)
    theirs = jmixup.mixup_cutmix_collate(7, seed=seed)
    for _ in range(6):
        for x, y in zip(ours((imgs, targets)), theirs((imgs, targets))):
            np.testing.assert_array_equal(x, y)


def _image(seed=1, size=(40, 32)):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3),
                                               dtype=np.uint8)
    return Image.fromarray(arr, "RGB")


@pytest.mark.parametrize("signed", [False, True])
def test_rand_augment_every_op_bit_equal(signed):
    """Each of the 14 ops at the default magnitude, both signs."""
    img = _image()
    ours = randaugment._op_space(31, img.size)
    theirs = jra._op_space(31, img.size)
    assert list(ours) == list(theirs) and len(ours) == 14
    for name in ours:
        fn, mags, sgn = ours[name]
        jfn, jmags, jsgn = theirs[name]
        np.testing.assert_array_equal(mags, jmags)
        assert sgn == jsgn
        mag = float(mags[9]) if mags.any() else 0.0
        if signed and sgn:
            mag = -mag
        np.testing.assert_array_equal(np.asarray(fn(img, mag)),
                                      np.asarray(jfn(img, mag)), err_msg=name)


def test_rand_augment_sequences_bit_equal():
    img = _image(3)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(40):
        np.testing.assert_array_equal(np.asarray(randaugment.rand_augment(img, a)),
                                      np.asarray(jra.rand_augment(img, b)))


def test_train_transform_with_rand_augment_bit_equal():
    """The in1k workers' transform: bilinear RandomResizedCrop + flip +
    RandAugment + normalize."""
    import functools

    from tae_tpu.data.transforms import \
        random_resized_crop_transform as jrrc
    from tae_tpu_torch.data.transforms import random_resized_crop_transform

    img = _image(4, (72, 60))
    ours = random_resized_crop_transform(
        32, interpolation="bilinear",
        post=functools.partial(randaugment.rand_augment))
    theirs = jrrc(32, interpolation="bilinear",
                  post=functools.partial(jra.rand_augment))
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(8):
        np.testing.assert_array_equal(ours(img, a), theirs(img, b))
