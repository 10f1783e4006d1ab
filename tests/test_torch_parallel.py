"""The port's multi-process layer (``tae_tpu_torch.parallel``) against the
JAX package's ``tae_tpu.parallel`` and against one process, on the CPU.

Several processes run through ``tae_tpu_torch.parallel.spawn``: each
spawned process uses one thread and meets the others through a
``FileStore`` under ``tmp_path`` (xdist workers cannot collide on a port),
and a process that hangs is killed at its timeout and fails the test. The
rank bodies live in ``tests/torch_parallel_workers.py``, which imports no
JAX. Inputs come from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tae_tpu import models as jmodels
from tae_tpu.models.tae import TAE as JTAE
from tae_tpu.models.tae import TAEConfig as JTAEConfig
from tae_tpu.parallel import make_mesh as j_make_mesh
from tae_tpu.parallel import param_shardings, shard_params
from tae_tpu.parallel.sharding import batch_sharding
from tae_tpu.train import TrainState as JTrainState
from tae_tpu.train import adamw as j_adamw
from tae_tpu.train import make_train_step as j_make_train_step
from tae_tpu.train import step_lr as j_step_lr
from tae_tpu.utils.dtypes import FP32 as J_FP32
from tae_tpu_torch import models
from tae_tpu_torch.ckpt.bridge import state_dict_from_jax
from tae_tpu_torch.parallel import (AXES, constrain_batch, make_mesh,
                                    param_placements, spawn)
from tae_tpu_torch.parallel.mesh import mesh_sizes

# a spawned run of a few processes: start-up, one or two tiny steps
TIMEOUT = 120
# one process against several: fp32 sums in another order
LOSS_RTOL = 1e-5
# gradients, through the gradient norm (the mean over ranks of FSDP2's
# reduce-scatter against one backward over the whole batch)
NORM_RTOL = 1e-5
# Parameters after AdamW steps at lr 1e-3. Adam divides each moment by the
# root of the second: an element whose gradient is small beside the
# rounding of the sums (the key biases, whose exact gradient is 0) or near
# eps moves by a share of one update whatever its size. So each element is
# held to a share of the step size (measured: 3.3e-5 after two steps at
# (2, 2, 1), 4.0e-6 on two ranks, 3.5e-6 on 3 of 49152 elements against
# JAX after one), not to 1e-6.
LR = 1e-3
PARAM_ATOL = 0.05 * LR


def _assert_params_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL,
                               err_msg=name)


def _run(fn, world, tmp_path, *args):
    return spawn.run(fn, world, *args, store=str(tmp_path / "store"),
                     timeout=TIMEOUT)


@pytest.fixture(scope="module")
def tiny():
    """The tiny TAE's parameters from JAX's init, in both layouts, and a
    global batch of 8 images."""
    jm = JTAE(JTAEConfig(**workers.TINY))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, jm.cfg).items()}
    images = np.random.default_rng(3).standard_normal(
        (8, 3, 32, 32)).astype(np.float32)
    return jm, params, sd, images


# --------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n,data,fsdp", [
    (1, -1, 1), (4, -1, 2), (4, 2, 2), (4, 4, 1), (8, -1, 2), (8, 2, 4),
    (4, -1, 3), (4, 3, 1), (1, -1, 2), (8, 2, 2)])
def test_make_mesh_counts_match_jax(n, data, fsdp):
    """The axis sizes, and the errors, of the JAX ``make_mesh`` on the same
    counts (the JAX side on n virtual CPU devices)."""
    try:
        want = j_make_mesh(data=data, fsdp=fsdp, tensor=1,
                           devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{str(e)}$".replace(
                "*", r"\*")):
            mesh_sizes(n, data, fsdp, 1)
        return
    assert dict(zip(AXES, mesh_sizes(n, data, fsdp, 1))) == dict(want.shape)


def test_tensor_axis_refuses():
    """The tensor axis is taken: only the JAX ``make_mesh``'s count errors
    refuse it (one process cannot hold a tensor axis of 2)."""
    with pytest.raises(ValueError, match=r"^1 devices not divisible by "
                                         r"fsdp\*tensor=2$"):
        make_mesh(tensor=2)
    with pytest.raises(ValueError, match=r"^1 devices not divisible by "
                                         r"fsdp\*tensor=2$"):
        j_make_mesh(tensor=2, devices=jax.devices()[:1])
    assert mesh_sizes(4, 1, 2, 2) == (1, 2, 2)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh()


def test_constrain_batch_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain_batch(x, {"data": 2}) is x


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("name,fsdp", [
    ("tae_patch32_vocab1024_px256", 4), ("tae_patch64_vocab4096_px256", 4),
    ("tae_patch128_vocab4096_px256", 8)])
def test_param_bytes_match_jax_shardings(name, fsdp):
    """Per-rank parameter bytes of the big configs (built on the meta
    device) against ``param_shardings``' per-device bytes on the same
    (8 // fsdp, fsdp, 1) mesh (the counterpart of
    tests/test_train.py::test_fsdp_placement_matches_scaling_md). FSDP2
    shards every leaf on dim 0 (1-D leaves too, which the JAX rules
    replicate) and pads what fsdp does not divide: the two agree within 1%,
    both at the 16 P / fsdp of the memory table."""
    model = models.create(name, device="meta")
    placed = param_placements(model, {"data": 8 // fsdp, "fsdp": fsdp})
    ours = sum(p.local_bytes(4) for p in placed.values())
    n_params = sum(p.numel() for p in model.parameters())

    jm = jmodels.create(name)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    leaves = jax.tree.leaves(shapes)
    assert sum(int(np.prod(l.shape)) for l in leaves) == n_params
    mesh = j_make_mesh(data=8 // fsdp, fsdp=fsdp, tensor=1)
    theirs = sum(int(np.prod(s.shard_shape(l.shape))) * 4 for l, s in
                 zip(leaves, jax.tree.leaves(param_shardings(shapes, mesh))))
    assert 0.99 <= ours / theirs <= 1.01, (ours, theirs)
    assert 1.0 <= 4 * ours / (16 * n_params / fsdp) < 1.01


def test_vocab6_falls_back_as_padding():
    """vocab 6 divides no fsdp of 4: the JAX rule replicates dict_proj's
    output dim; FSDP2 pads it (2 rows a rank, the last rank's empty)."""
    kw = dict(workers.TINY, vocab_size=6)
    jm = JTAE(JTAEConfig(**kw))
    mesh = j_make_mesh(data=1, fsdp=4, tensor=2)
    spec = param_shardings(jm.init(jax.random.key(0)),
                           mesh)["encoder"]["dict_proj"]["w"].spec
    assert len(spec) == 0 or spec[-1] is None
    model = workers.tiny_model(cfg_kw=kw)
    placed = param_placements(model, {"data": 1, "fsdp": 4})
    assert placed["dict_proj.weight"].shape == (6, 64)
    assert placed["dict_proj.weight"].local_shape == (2, 64)
    assert placed["dict_proj.weight"].padded
    assert not placed["blocks.0.attn.qkv.weight"].padded
    assert placed["blocks.0.attn.qkv.weight"].local_shape == (48, 64)


# ---------------------------------------------------------- process plumbing

def test_plumbing_over_four_ranks(tmp_path):
    """The (2, 2, 1) mesh and each rank's rows; meters and confusion
    matrices summed over the ranks; rank 0 the main process."""
    out = _run(workers.plumbing, 4, tmp_path)
    for rank, r in enumerate(out):
        assert r["names"] == ("data", "fsdp", "tensor")
        assert r["shape"] == (2, 2, 1)
        assert r["data_rank"] == (rank, 4)
        assert r["rows"] == [2 * rank, 2 * rank + 1]
        assert r["main"] == (rank == 0)
        # rank r adds r + 1 values 10 r + v, each twice
        assert r["count"] == 2 * sum(k + 1 for k in range(4))
        assert r["total"] == 2 * sum(10 * k + v for k in range(4)
                                     for v in range(k + 1))
        want = np.zeros((3, 3), np.int64)
        for k in range(4):
            for t, p in zip([0, 1, 2], [k % 3, 1, 0]):
                want[t, p] += 1
        np.testing.assert_array_equal(r["mat"], want)


# ------------------------------------------------------------ sharded steps

@pytest.mark.parametrize("sizes", [(1, 2, 1), (2, 1, 1), (2, 2, 1)])
def test_sharded_train_matches_one_process(sizes, tiny, tmp_path):
    _, _, sd, images = tiny
    one = workers.train_steps(None, sd, images, 2)
    losses, norms, params = _run(workers.sharded_train,
                                 sizes[0] * sizes[1], tmp_path, sizes, sd,
                                 images, 2)[0]
    np.testing.assert_allclose(losses, one[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, one[1], rtol=NORM_RTOL)
    assert losses[1] < losses[0]
    for name, want in one[2].items():
        _assert_params_close(params[name], want, name)


def test_sharded_step_matches_jax_sharded_step(tiny, tmp_path):
    """One step on (2, 2, 1) against the JAX step jitted over its virtual
    (2, 2, 1) mesh, from the same parameters and images (no decay: the JAX
    rule decays its depth-stacked 1-D leaves, test_torch_train says why)."""
    jm, params, sd, images = tiny
    mesh = j_make_mesh(data=2, fsdp=2, tensor=1, devices=jax.devices()[:4])
    opt = j_adamw(weight_decay=0.0)
    step = jax.jit(j_make_train_step(
        lambda p, b: (jm.forward(p, b, policy=J_FP32)[0], {}), opt,
        j_step_lr(LR, 1e-4, 100)))
    state = JTrainState.create(shard_params(params, mesh), opt)
    state, metrics = step(state, jax.device_put(images, batch_sharding(mesh)),
                          jnp.int32(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params), jm.cfg)

    losses, norms, got = _run(workers.sharded_train, 4, tmp_path, (2, 2, 1),
                              sd, images, 1, 0.0)[0]
    np.testing.assert_allclose(losses[0], float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms[0], float(metrics["grad_norm"]),
                               rtol=1e-4)
    for name, w in want.items():
        _assert_params_close(got[name], w.numpy(), name)


def test_cross_mesh_checkpoint_restore(tiny, tmp_path):
    """Saved on (2, 2, 1) after two steps with bf16 moments; restored on
    (1, 2, 1) and in one process: parameters and moments bit for bit, the
    moments still bf16, each rank holding its own shard."""
    _, _, sd, images = tiny
    path = str(tmp_path / "ck" / "latest.pt")
    saved_params, saved_moments = spawn.run(
        workers.save_sharded, 4, (2, 2, 1), sd, images, path,
        store=str(tmp_path / "store_a"), timeout=TIMEOUT)[0]
    two = spawn.run(workers.restore_sharded, 2, (1, 2, 1), path,
                    store=str(tmp_path / "store_b"), timeout=TIMEOUT)
    one = workers.restore_one(path)
    for restored, step, params, moments, local in (two[0], one):
        assert restored and step == 2
        for name, want in saved_params.items():
            np.testing.assert_array_equal(params[name], want, err_msg=name)
            dtype, m, v = moments[name]
            assert dtype == "torch.bfloat16"
            np.testing.assert_array_equal(m, saved_moments[name][1])
            np.testing.assert_array_equal(v, saved_moments[name][2])
    rows = {n: s[0] for n, s in two[1][4].items()}
    assert rows["blocks.0.attn.qkv.weight"] == 96      # 192 over fsdp 2
    assert one[4]["blocks.0.attn.qkv.weight"] == (192, 64)
