"""The port's ssm family (xLSTM: mLSTM and sLSTM layers) against the
reference's, on the CPU.

``repro_torch.models.xlstm.MLSTMBlock`` and ``SLSTMBlock`` take the same
seeded numpy weights and inputs as the reference's blocks (their norm
scales moved off zero): the mLSTM's chunkwise-parallel forward in chunks
of 8 over 32 positions and in one chunk, its final state, and its
recurrent decode, against the reference and against each other; the
sLSTM's time loop, its final state and its decode.  Float32, to
``atol = rtol = 1e-4``.  The LM-level cases (``tests/torch_recurrent.py``)
run the smoke model at 3 layers: one mLSTM + sLSTM unit and an mLSTM tail.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.xlstm import MLSTMBlock as RefMLSTM
from repro.models.xlstm import SLSTMBlock as RefSLSTM

from repro_torch.models.xlstm import (M_START, MLSTMBlock, MLSTMState,
                                      SLSTMBlock, SLSTMState)

from test_torch_moe import twin_layer
from torch_recurrent import (F32_TOL, configs,  # noqa: F401
                             test_checkpoint_keys_equal_the_reference_flatten,
                             test_decode_advances_the_state,
                             test_forward_matches_reference,
                             test_full_width_shapes_match_reference,
                             test_greedy_generation_matches_reference,
                             test_interop_round_trip,
                             test_loss_and_grads_match_reference,
                             test_meta_build_then_init_equals_a_direct_build,
                             test_port_checkpoint_restores_in_the_reference,
                             test_prefill_and_decode_match_reference,
                             test_prefill_decode_matches_forward,
                             test_reference_checkpoint_restores_in_the_port,
                             test_remat_and_no_remat_grads_are_bit_equal,
                             test_train_step_matches_reference,
                             test_trainer_checkpoints_under_the_reference_names)

# depth tier: jax compiles each reference model's scans
pytestmark = pytest.mark.slow

ARCH = "xlstm_350m"


@pytest.fixture
def arch():
    return ARCH


def inputs(cfg, S, seed, B=2):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def assert_state_close(mine, theirs):
    for f in theirs._fields:
        np.testing.assert_allclose(getattr(mine, f).numpy(),
                                   np.asarray(getattr(theirs, f)),
                                   **F32_TOL, err_msg=f)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunked_forward_matches_reference(chunk):
    """Chunks of 8 (four chunks and their recurrence) and one chunk of 32:
    the output and the final (C, n, m) against the reference's."""
    rcfg, pcfg = configs(ARCH)
    ref, params, port = twin_layer(RefMLSTM, MLSTMBlock, rcfg, pcfg, "xm",
                                   chunk)
    assert port.wif.dtype == torch.float32
    x = inputs(pcfg, 32, chunk + 1)
    want, r_state = ref.forward(params, jnp.asarray(x), return_state=True,
                                chunk=chunk)
    with torch.inference_mode():
        got, state = port(torch.from_numpy(x), return_state=True,
                          chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert_state_close(state, r_state)


def test_mlstm_chunked_forward_equals_its_recurrent_decode():
    """Within the port: the chunked forward (chunks of 8) equals the
    recurrent cell run from the initial state, position by position, and
    ends in the same state; decode steps continue the forward's state as
    the reference's decode does."""
    rcfg, pcfg = configs(ARCH)
    ref, params, port = twin_layer(RefMLSTM, MLSTMBlock, rcfg, pcfg, "xm", 3)
    x = inputs(pcfg, 36, 4)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        full, state = port(xt[:, :32], return_state=True, chunk=8)
        zero = port.init_state(2)
        assert isinstance(zero, MLSTMState) and \
            bool((zero.m == M_START).all())
        steps = torch.cat([port.decode(xt[:, t:t + 1], zero)
                           for t in range(32)], 1)
        torch.testing.assert_close(steps, full, **F32_TOL)
        for f in ("c", "n", "m"):
            torch.testing.assert_close(getattr(zero, f), getattr(state, f),
                                       **F32_TOL)
        _, r_state = ref.forward(params, jnp.asarray(x[:, :32]),
                                 return_state=True, chunk=8)
        for t in range(32, 36):
            r_y, r_state = ref.decode(params, jnp.asarray(x[:, t:t + 1]),
                                      r_state)
            y = port.decode(xt[:, t:t + 1], state)
            np.testing.assert_allclose(y.numpy(), np.asarray(r_y),
                                       **F32_TOL)
    assert_state_close(state, r_state)


def test_mlstm_rejects_a_sequence_off_the_chunk():
    rcfg, pcfg = configs(ARCH)
    _, _, port = twin_layer(RefMLSTM, MLSTMBlock, rcfg, pcfg, "xm", 5)
    with pytest.raises(AssertionError):
        port(torch.zeros(1, 12, pcfg.d_model), chunk=8)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def test_slstm_matches_reference():
    """The time loop's output against the reference's forward; its final
    state and four decode steps from it against the reference's cell and
    decode."""
    rcfg, pcfg = configs(ARCH)
    ref, params, port = twin_layer(RefSLSTM, SLSTMBlock, rcfg, pcfg, "xs", 7)
    assert port.wx.dtype == port.r.dtype == torch.float32
    S = 16
    x = inputs(pcfg, S + 4, 8)
    want = ref.forward(params, jnp.asarray(x[:, :S]))
    xg = jnp.asarray(x[:, :S]) @ params["xs.wx"]
    r_state = ref.init_state(2)
    for t in range(S):
        _, r_state = ref._cell(params, xg[:, t], r_state)
    with torch.inference_mode():
        got, state = port(torch.from_numpy(x[:, :S]), return_state=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        assert isinstance(state, SLSTMState)
        assert_state_close(state, r_state)
        for t in range(S, S + 4):
            r_y, r_state = ref.decode(params, jnp.asarray(x[:, t:t + 1]),
                                      r_state)
            y = port.decode(torch.from_numpy(x[:, t:t + 1]), state)
            np.testing.assert_allclose(y.numpy(), np.asarray(r_y),
                                       **F32_TOL)
    assert_state_close(state, r_state)


def test_slstm_gradients_match_reference():
    """Through the time loop, and through the stabiliser's tie at the
    first position (n == 1), where jnp.maximum splits the gradient."""
    rcfg, pcfg = configs(ARCH)
    ref, params, port = twin_layer(RefSLSTM, SLSTMBlock, rcfg, pcfg, "xs", 9)
    x = inputs(pcfg, 12, 10)
    loss_fn = jax.jit(jax.grad(lambda p, x: jnp.sum(ref.forward(p, x) ** 2),
                               argnums=(0, 1)))
    r_gp, r_gx = loss_fn(params, jnp.asarray(x))
    named = dict(port.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    grads = torch.autograd.grad((port(xt) ** 2).sum(),
                                [xt] + list(named.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(r_gx),
                               rtol=1e-4, atol=1e-4 * float(np.abs(
                                   np.asarray(r_gx)).max()))
    for (name, _), g in zip(named.items(), grads[1:]):
        want = np.asarray(r_gp[f"xs.{name}"])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
