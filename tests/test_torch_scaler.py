"""The port's dynamic loss scale (``tae_tpu_torch.train.scaler``) against
the JAX package's (``tae_tpu.train.scaler``): the same gradient trees, made
with numpy, through both, and the scales, growth trackers, ``finite`` flags
and unscaled gradients compared exactly. Every scale is a power of two and
every gradient value a bf16-exact number whose unscaled value stays a
normal fp32 number (XLA on the CPU flushes subnormal results to zero,
PyTorch does not), so the two sides have no rounding to differ in.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tae_tpu.train.scaler import DynamicLossScale as JDynamicLossScale
from tae_tpu.train.scaler import NoOpLossScale as JNoOpLossScale
from tae_tpu.train.scaler import ScalerState as JScalerState
from tae_tpu_torch.train.scaler import (DynamicLossScale, NoOpLossScale,
                                        ScalerState)

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _both(arrays):
    """numpy (name, array) leaves -> (port tensors, JAX arrays), each in
    its dtype."""
    port = [torch.from_numpy(a).to(DTYPES[d][0]) for d, a in arrays]
    jax_ = [jnp.asarray(a).astype(DTYPES[d][1]) for d, a in arrays]
    return port, jax_


def _same_state(state, jstate):
    assert state.scale.dtype == torch.float32
    assert state.growth_tracker.dtype == torch.int32
    assert float(state.scale) == float(jstate.scale)
    assert int(state.growth_tracker) == int(jstate.growth_tracker)


def _same_grads(grads, jgrads):
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert g.dtype == torch.float32 and jg.dtype == jnp.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_dynamic_loss_scale_sequence_matches_jax():
    """tests/test_train.py's test_dynamic_loss_scale through both packages:
    a finite step, the step that reaches ``growth_interval``, a step with
    an inf; the state's tensors updated in place."""
    scaler, jscaler = DynamicLossScale(growth_interval=2), \
        JDynamicLossScale(growth_interval=2)
    state, jstate = ScalerState.create(init_scale=8.0), \
        JScalerState.create(init_scale=8.0)
    held = (state.scale.data_ptr(), state.growth_tracker.data_ptr())
    loss = scaler.scale(state, torch.tensor(2.0))
    assert float(loss) == float(jscaler.scale(jstate, jnp.float32(2.0))) == 16
    good = np.asarray([8.0, 16.0], np.float32)
    bad = np.asarray([np.inf, 1.0], np.float32)
    for arr, want in ((good, (8.0, 1, True)), (good, (16.0, 0, True)),
                      (bad, (8.0, 0, False))):
        g, jg = _both([("fp32", arr)])
        g, state, finite = scaler.unscale_and_update(state, {"w": g[0]})
        jg, jstate, jfinite = jscaler.unscale_and_update(jstate,
                                                         {"w": jg[0]})
        _same_state(state, jstate)
        assert bool(finite) == bool(jfinite) == want[2]
        assert (float(state.scale), int(state.growth_tracker)) == want[:2]
        _same_grads([g["w"]], [jg["w"]])
    np.testing.assert_array_equal(g["w"].numpy(), [0.0, 0.0])
    assert (state.scale.data_ptr(), state.growth_tracker.data_ptr()) == held


_BAD = [math.inf, -math.inf, math.nan]
# mostly finite values, now and then inf, -inf or nan: m * 2^e with an
# 8-bit mantissa (exact in bf16)
_value = st.tuples(st.integers(-255, 255), st.integers(-20, 20),
                   st.sampled_from([None] * 24 + _BAD)).map(
    lambda t: t[2] if t[2] is not None else math.ldexp(t[0], t[1]))
_leaf = st.tuples(st.sampled_from(sorted(DTYPES)),
                  st.lists(_value, min_size=1, max_size=6))
_step = st.lists(_leaf, min_size=1, max_size=4)


@settings(max_examples=60, deadline=None, database=None)
@given(init_exp=st.integers(-4, 20), interval=st.integers(1, 3),
       growth=st.sampled_from([2.0, 4.0]), backoff=st.sampled_from([0.5,
                                                                    0.25]),
       steps=st.lists(_step, min_size=1, max_size=6))
def test_sequences_match_jax(init_exp, interval, growth, backoff, steps):
    """Random sequences of gradient trees, finite and not, fp32 and bf16
    leaves mixed: every step's scale, tracker, ``finite`` and unscaled
    gradients exactly equal to the JAX package's."""
    kw = dict(growth_factor=growth, backoff_factor=backoff,
              growth_interval=interval)
    scaler, jscaler = DynamicLossScale(**kw), JDynamicLossScale(**kw)
    state = ScalerState.create(init_scale=2.0 ** init_exp)
    jstate = JScalerState.create(init_scale=2.0 ** init_exp)
    for leaves in steps:
        g, jg = _both([(d, np.asarray(v, np.float32)) for d, v in leaves])
        g, state, finite = scaler.unscale_and_update(state, g)
        jg, jstate, jfinite = jscaler.unscale_and_update(jstate, jg)
        assert finite.dtype == torch.bool and finite.shape == ()
        assert bool(finite) == bool(jfinite)
        _same_state(state, jstate)
        _same_grads(g, jg)


def test_no_op_loss_scale():
    scaler, jscaler = NoOpLossScale(), JNoOpLossScale()
    state = ScalerState.create()
    loss = torch.tensor(3.0)
    assert scaler.scale(state, loss) is loss
    grads = [torch.tensor([np.inf, 1.0]), torch.ones(2, dtype=torch.bfloat16)]
    out, same, finite = scaler.unscale_and_update(state, grads)
    _, _, jfinite = jscaler.unscale_and_update(JScalerState.create(), [])
    assert out is grads and same is state
    assert finite.dtype == torch.bool and bool(finite) == bool(jfinite)
    assert float(state.scale) == 2.0 ** 16 and int(state.growth_tracker) == 0


def test_unscale_and_update_reads_nothing_on_the_host(monkeypatch):
    """No value crosses to the host inside the update: a read of a tensor's
    value there raises, and the update still runs (finite and not)."""
    scaler = DynamicLossScale(growth_interval=1)
    state = ScalerState.create(init_scale=4.0)
    grads = {"a": torch.tensor([4.0, 8.0]),
             "b": [torch.ones(3, dtype=torch.bfloat16)]}
    bad = {"a": torch.tensor([4.0, math.nan]), "b": [torch.ones(3)]}

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside unscale_and_update")

    results = []
    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        for tree in (grads, bad):
            out, state, finite = scaler.unscale_and_update(state, tree)
            results.append((out, finite.clone(), state.scale.clone()))
    (g1, f1, s1), (g2, f2, s2) = results
    assert bool(f1) and not bool(f2)
    assert float(s1) == 8.0 and float(s2) == 4.0
    assert torch.equal(g1["a"], torch.tensor([1.0, 2.0]))
    assert torch.equal(g2["b"][0], torch.zeros(3))
