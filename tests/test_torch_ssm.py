"""The port's hybrid family (zamba2: Mamba2 plus one shared attention
block) against the reference's, on the CPU.

``repro_torch.models.ssm.Mamba2Block`` takes the same seeded numpy
weights and inputs as the reference's ``Mamba2Block`` (its constant
vectors moved off their constants): the chunked SSD forward over one and
over three chunks, the state it returns, and decode steps from that
state, each in float32 to ``atol = rtol = 1e-4``; within the port,
prefill plus decode equals the forward to 1e-4.  The shared attention
block is one set of parameters.  The LM-level cases
(``tests/torch_recurrent.py``) run the smoke model at 5 layers: two units
of the shared block and 2 Mamba2 layers (``attn_every = 2``), and a
Mamba2 tail.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from repro.models.ssm import Mamba2Block as RefMamba2

from repro_torch.models.layers import cross_entropy
from repro_torch.models.model import LM
from repro_torch.models.ssm import Mamba2Block, SSMState
from repro_torch.train.train_step import init_train_state

from test_torch_moe import twin_layer
from torch_recurrent import (F32_TOL, batch_of, configs,  # noqa: F401
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
import torch_threads  # noqa: F401

# depth tier: jax compiles each reference model's scans
pytestmark = pytest.mark.slow

ARCH = "zamba2_2p7b"


@pytest.fixture
def arch():
    return ARCH


def twin_mamba(seed):
    rcfg, pcfg = configs(ARCH)
    return twin_layer(RefMamba2, Mamba2Block, rcfg, pcfg, "ssm", seed)


# ---------------------------------------------------------------------------
# Mamba2Block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 48])
def test_mamba2_block_matches_reference(S):
    """forward (one chunk of 16, then three), the prefill state, and four
    decode steps from it, against the reference."""
    ref, params, port = twin_mamba(S)
    assert port.D.dtype == port.A_log.dtype == port.dt_bias.dtype \
        == torch.float32
    d, steps = port.cfg.d_model, 4
    x = np.random.default_rng(S + 1).normal(
        size=(2, S + steps, d)).astype(np.float32)
    want, r_state = ref.forward(params, jnp.asarray(x[:, :S]),
                                return_state=True)
    with torch.inference_mode():
        got, state = port(torch.from_numpy(x[:, :S]), return_state=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        for mine, theirs in ((state.s, r_state.s), (state.conv,
                                                    r_state.conv)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       **F32_TOL)
        for t in range(S, S + steps):
            xt = x[:, t:t + 1]
            r_y, r_state = ref.decode(params, jnp.asarray(xt), r_state)
            y = port.decode(torch.from_numpy(xt), state)
            np.testing.assert_allclose(y.numpy(), np.asarray(r_y),
                                       **F32_TOL)
        np.testing.assert_allclose(state.s.numpy(), np.asarray(r_state.s),
                                   **F32_TOL)


def test_mamba2_decode_continues_the_forward():
    """Within the port: the forward's state plus decode steps equal the
    forward over the longer sequence, position by position; and from a
    zero state, decode steps alone give the forward's outputs."""
    _, _, port = twin_mamba(3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 32, port.cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        full = port(x)
        _, state = port(x[:, :16], return_state=True)
        steps = [port.decode(x[:, t:t + 1], state) for t in range(16, 32)]
        torch.testing.assert_close(torch.cat(steps, 1), full[:, 16:],
                                   **F32_TOL)
        zero = port.init_state(2)
        assert isinstance(zero, SSMState) and not zero.s.any()
        steps = [port.decode(x[:, t:t + 1], zero) for t in range(8)]
        torch.testing.assert_close(torch.cat(steps, 1), full[:, :8],
                                   **F32_TOL)


def test_mamba2_rejects_a_sequence_off_the_chunk():
    _, _, port = twin_mamba(5)
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        port(torch.zeros(1, 24, port.cfg.d_model))


class _Largest(TorchDispatchMode):
    """The most elements of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_mamba2_intra_chunk_product_stays_at_the_reference_size():
    """No op of the forward returns more elements than the reference's
    [B, nc, Q, Q, H] decay matrix (a three-operand einsum contracted left
    to right would build [B, nc, Q, Q, H, P]).  Chunk 64, so that the
    decay matrix outgrows the projections, as at full width."""
    rcfg, pcfg = configs(ARCH)
    ssm = dataclasses.replace(pcfg.ssm, chunk=64)
    _, _, port = twin_layer(RefMamba2, Mamba2Block, rcfg.scaled(ssm=ssm),
                            pcfg.scaled(ssm=ssm), "ssm", 6)
    B, S, Q, H = 2, 128, 64, port.heads
    x = torch.zeros(B, S, port.cfg.d_model)
    with torch.inference_mode(), _Largest() as seen:
        port(x)
    assert seen.numel <= B * (S // Q) * Q * Q * H


# ---------------------------------------------------------------------------
# the shared attention block
# ---------------------------------------------------------------------------

def test_shared_block_is_one_set_of_parameters():
    """``shared.*`` once in the state dict and once in ``parameters()``,
    even counting duplicates: no unit registers it."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu")
    assert len(lm.segments["units"]) == 2 and lm.shared is not None
    shared = dict(lm.shared.named_parameters())
    assert shared
    every = list(lm.named_parameters(remove_duplicate=False))
    for name, p in shared.items():
        assert sum(q is p for _, q in every) == 1, name
    keys = [k for k in lm.state_dict() if ".ln1" in k or ".attn." in k]
    assert keys == [f"shared.{k}" for k in shared
                    if k.startswith(("ln1", "attn."))]
    assert len(every) == len(lm.state_dict())


def test_shared_block_gradient_sums_over_units():
    """The shared block's gradient equals the sum of the gradients of
    per-unit copies of it (each unit applying its own copy), and the
    train state holds each of its parameters once, so AdamW updates it
    once."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(8))
    b = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
    params = [p.requires_grad_(True) for p in lm.shared.parameters()]
    whole = torch.autograd.grad(lm.loss(b), params)

    units = lm.segments["units"]
    copies = [copy.deepcopy(lm.shared) for _ in units]
    x = lm._embed(b["tokens"])
    positions = lm._positions(x)
    for unit, own in zip(units, copies):
        x = unit(x, positions, shared=own)
    x = lm.segments["tail"](x, positions)
    loss = cross_entropy(lm._head(x), b["labels"])
    per_unit = torch.autograd.grad(
        loss, [p for c in copies for p in c.parameters()])
    n = len(params)
    for i, g in enumerate(whole):
        torch.testing.assert_close(g, sum(per_unit[i::n]), atol=1e-6,
                                   rtol=1e-5)
    state = init_train_state(lm)
    held = [p for p in state.params.values()]
    assert all(sum(q is p for q in held) == 1 for p in params)
    assert set(state.opt.m) == set(state.params) == set(lm.state_dict())
