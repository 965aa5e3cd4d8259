"""Every family placed on a mesh, against the reference, on the CPU.

One spawned 4-rank gloo world (``tests/torch_placed_world.py``) places
the port's smoke models (float32) on a (2, 2) ``("data", "model")`` mesh
with ``launch.specs.place_cell`` and runs:

* one train step of granite-moe, DeepSeek-V2 (MLA), zamba2, xLSTM, gemma3
  (tied embeddings), Llama-3.2-Vision (the image context placed too) and
  HuBERT (frames placed), all by ``arch_rules``, and of qwen3 under
  ``SP_FSDP_RULES`` with the sequence-parallel activation constraint:
  every family.  Each step's parameters, loss
  and grad norm are held within 2e-5 (``GATE``, tests/test_dist.py's
  GSPMD gate) of the reference's single-device ``make_train_step`` run
  here on the same weights, and of the port's plain step; and each step
  moves the parameters more than ten times the gate, so that the gate
  can fail;
* a placed prefill and four greedy decode steps of qwen3, granite-moe,
  zamba2, xLSTM and Llama-3.2-Vision on placed caches: the tokens equal
  the plain run's, and each step's logits are within ``LOGIT_TOL`` of
  max|logits| of the plain run's (the model axis splits products whose
  partial sums then add in another order);
* HuBERT's placed encode, held the same way.

Beside the world, one rank on a (1, 1) mesh holds every case placed bit
for bit to the plain path.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as ref_get_smoke
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.interop import lm_reference_name
from repro_torch.models.model import LM

import torch_placed_world as W
import torch_threads  # noqa: F401

GATE = 2e-5                 # tests/test_dist.py's GSPMD gate
LOGIT_TOL = 1e-5            # serving: |placed - plain| / max|plain|
CASES = [c for c, _, _ in W.TRAIN]


def ref_config(arch: str):
    return ref_get_smoke(arch).scaled(num_layers=W.LAYERS[arch], **W.F32)


def reference_arrays(arch: str, seed: int = 0) -> dict:
    """The reference's initial parameters as float32 numpy, each
    constant one (the zero norm scales) moved off its constant by seeded
    noise, so that every parameter's step is a real one."""
    params = RefLM(ref_config(arch)).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(params):
        a = np.asarray(params[k], np.float32)
        if np.ptp(a) == 0:
            a = a + (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = tmp_path_factory.mktemp("placed_world")
    for arch in W.ARCHS:
        np.savez(out / f"{arch}.npz", **reference_arrays(arch))
    return out


@pytest.fixture(scope="module")
def runs(weights):
    """The world, run in a thread while the reference's steps compile."""
    box = {}

    def go():
        try:
            box["out"] = W.run_world(weights, weights)
        except BaseException as exc:  # noqa: BLE001
            box["exc"] = exc

    thread = threading.Thread(target=go)
    thread.start()
    yield thread, box


def joined(runs):
    thread, box = runs
    thread.join()
    if "exc" in box:
        raise box["exc"]
    return box["out"]


@pytest.fixture(scope="module")
def ref_steps(weights, runs):
    """The reference's single-device step of each train case on the
    world's weights and batch: (parameters by the port's names, loss,
    grad_norm, the most any parameter moved)."""
    out = {}
    for case, arch, _ in W.TRAIN:
        cfg = ref_config(arch)
        lm = RefLM(cfg)
        arrays = dict(np.load(weights / f"{arch}.npz"))
        shapes = lm.abstract_params()
        params = {k: jnp.asarray(a).astype(shapes[k].dtype)
                  for k, a in arrays.items()}
        b = {k: jnp.asarray(v) for k, v in W.train_batch(cfg).items()}
        state = RefTrainState(params, ref_optim.init_state(params))
        new, metrics = jax.jit(ref_make_train_step(
            lm, ref_optim.AdamWConfig(**W.OPT)))(state, b)
        want = {k: np.asarray(v, np.float32) for k, v in new.params.items()}
        moved = max(float(np.abs(want[k] - arrays[k]).max()) for k in want)
        port = LM(W.config(arch), device="meta")
        by_port = {}
        for n, _ in port.named_parameters():
            r, idx = lm_reference_name(n, port.reference_prefixes)
            by_port[n] = want[r][idx]
        out[case] = (by_port, float(metrics["loss"]),
                     float(metrics["grad_norm"]), moved)
    return out


@pytest.fixture(scope="module")
def world(runs, ref_steps):
    return joined(runs)[0]


@pytest.fixture(scope="module")
def one(runs, ref_steps):
    return joined(runs)[1]


def params_of(res: dict, pre: str) -> dict:
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def max_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(float(np.abs(got[n] - want[n]).max()) for n in want)


@pytest.mark.parametrize("case", CASES)
def test_placed_step_matches_the_reference_single_device_step(
        world, ref_steps, case):
    want, loss, gnorm, moved = ref_steps[case]
    assert moved > 10 * GATE, moved                 # the gate can fail
    for res in world:
        pre = f"train/{case}/"
        diff = max_diff(params_of(res, pre + "params/"), want)
        print(f"{case}: placed step {diff:.3g} from the reference's "
              f"single-device step (gate {GATE}); the step moves the "
              f"parameters {moved:.3g}")
        assert diff < GATE, (diff, moved)
        assert abs(float(res[pre + "loss"]) - loss) < GATE
        assert abs(float(res[pre + "grad_norm"]) - gnorm) < GATE


@pytest.mark.parametrize("case", CASES)
def test_placed_step_matches_the_ports_plain_step(world, one, case):
    pre = f"train/{case}/"
    want = params_of(one, f"plain/{pre}params/")
    for res in world:
        assert max_diff(params_of(res, pre + "params/"), want) < GATE
        assert abs(float(res[pre + "loss"])
                   - float(one[f"plain/{pre}loss"])) < GATE
        assert abs(float(res[pre + "grad_norm"])
                   - float(one[f"plain/{pre}grad_norm"])) < GATE


@pytest.mark.parametrize("case", CASES)
def test_placed_step_shards_and_agrees_across_ranks(world, case):
    pre = f"train/{case}/"
    for res in world:
        assert int(res[pre + "sharded"]) > 0
    for res in world[1:]:
        for k, v in res.items():
            if k.startswith(pre + "params/"):
                np.testing.assert_array_equal(v, world[0][k], err_msg=k)


@pytest.mark.parametrize("arch", W.SERVE)
def test_placed_serving_gives_the_plain_tokens(world, one, arch):
    pre = f"serve/{arch}/"
    want = one[f"plain/{pre}tokens"]
    for res in world:
        assert bool(res[pre + "caches_placed"])
        np.testing.assert_array_equal(res[pre + "tokens"], want)
        for i in range(W.DECODE + 1):
            got, ref = res[f"{pre}logits{i}"], one[f"plain/{pre}logits{i}"]
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            assert err < LOGIT_TOL, (i, err)


def test_placed_encode_matches_the_plain_encode(world, one):
    pre = f"serve/{W.ENCODE}/"
    ref = one[f"plain/{pre}logits0"]
    for res in world:
        err = float(np.abs(res[pre + "logits0"] - ref).max()
                    / np.abs(ref).max())
        assert err < LOGIT_TOL, err


@pytest.mark.parametrize("key", [f"train/{c}" for c in CASES]
                         + [f"serve/{a}" for a in W.SERVE + (W.ENCODE,)])
def test_placed_on_one_rank_is_bit_equal_to_plain(one, key):
    """A (1, 1) mesh: placed and plain agree bit for bit: parameters,
    losses and grad norms of the train step, tokens and logits of
    serving and encoding."""
    names = [k for k in one if k.startswith(f"plain/{key}/")
             and not k.endswith(("sharded", "caches_placed"))]
    assert names
    for k in names:
        np.testing.assert_array_equal(one[k.replace("plain/", "placed/", 1)],
                                      one[k], err_msg=k)
