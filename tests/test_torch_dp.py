"""The port's explicit data parallelism against the reference, on the CPU.

One module-scoped world of 4 spawned ranks over gloo
(``tests/torch_dp_world.py``) runs the port; the reference runs here, in
this process, on the same inputs.  What each test holds, and to what:

* ``compressed_psum``, per rank, bit-equal (``mean`` and the new residual)
  to the reference's under ``jax.vmap(..., axis_name="data")`` over the
  same stacked per-rank arrays: both do the same float32 operations in
  the same order, and the int32 sum of the payloads is exact;
* one uncompressed DP step (qwen3_8b smoke, 2 layers, float32, 8 x 16,
  ``grad_clip=0``, the warmup's first step at the full lr) within 2e-5
  (max |difference|, the reference's own gate in ``tests/test_dist.py``)
  of the reference's single-device ``make_train_step`` on the whole
  batch, and of the port's.  Adam's first update is about lr in every
  element whatever the gradient's scale, so the parameters (which move
  ~4e-4, far past the gate) catch a gradient whose signs are wrong, and
  the loss and ``grad_norm`` (within 2e-5 too) one whose scale is wrong;
* five compressed steps (lr 1e-3) against an oracle made of the
  reference's pieces (per-rank ``value_and_grad`` of ``make_loss_fn``,
  ``compressed_psum`` under vmap, ``apply_updates``: the shard body of
  ``make_dp_shard_map_step`` without ``shard_map``): each step's loss
  within 1e-4 and its ``grad_norm`` within 1e-4 (relative), and the
  parameters to the reference's criteria (loss gap < 0.05, ``rel_drift``
  < 2.0) and replicated across the ranks.  Not bit for bit: one float32
  rounding of a gradient can flip an int8 ``q``, and Adam then moves that
  element by about lr (PERF.md §6);
* three uncompressed steps of granite-moe's smoke config in bfloat16
  against the port's one-process step with a microbatch per rank, within
  ``chip_smoke.py``'s ``DP_WORLD_TOL`` (the limit of phase 16 (a) at a
  world of more than one card);
* the histograms bit-equal to ``np.bincount`` of the reference's numpy
  ``hash_partition`` and to the port's one-device functions;
* the mesh functions' shapes and names, and their refusals (a shape the
  world does not fill; no process group).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as ref_get_smoke
from repro.dist.partition import hash_partition as ref_hash_partition
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import compressed_psum as ref_compressed_psum
from repro.train.train_step import make_loss_fn as ref_make_loss_fn
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.configs import get_smoke
from repro_torch.dist.partition import (partition_histogram,
                                        sharded_potential_counts)
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_state_dict_from_arrays)
from repro_torch.launch.mesh import (make_local_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models.model import LM
from repro_torch.train import (AdamWConfig, compressed_psum,
                               init_train_state, make_dp_shard_map_step,
                               make_train_step)

import torch_dp_world as W

EXACT_TOL = 2e-5            # the reference's gate, tests/test_dist.py
LOSS_TOL = 1e-4             # each compressed step's loss, absolute
GNORM_RTOL = 1e-5           # grad_norm, relative: float32 sums in another
                            # order
GNORM_INT8_RTOL = 1e-4      # the compressed steps' grad_norm, relative: a
                            # flipped q moves an element by scale / n
DP_WORLD_TOL = 2.0 ** -8    # chip_smoke.py's: L2 per tensor, relative
LOSS_GAP = 0.05             # tests/test_dist.py's criteria
REL_DRIFT = 2.0
F32 = dict(num_layers=2, param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def ref():
    cfg = ref_get_smoke("qwen3_8b").scaled(**F32)
    lm = RefLM(cfg)
    params = lm.init(jax.random.key(0))
    return lm, params, {k: np.asarray(v, np.float32)
                        for k, v in params.items()}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_world")
    np.savez(out / "weights.npz", **ref[2])
    return W.run_world(out, out / "weights.npz")


def ref_names(res: dict, tag: str) -> dict:
    """A rank's saved parameters under the reference's names."""
    pre = f"{tag}/params/"
    return lm_arrays_from_state_dict(
        {k[len(pre):]: torch.from_numpy(v) for k, v in res.items()
         if k.startswith(pre)})


def max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k], np.float32)
                            - np.asarray(b[k], np.float32)).max())
               for k in a)


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# -- the mesh ----------------------------------------------------------------

def test_mesh_shapes_and_names(world):
    for res in world:
        assert tuple(res["mesh/shape"]) == (W.WORLD,)
        assert tuple(res["mesh/names"]) == ("data",)
        assert tuple(res["local/shape"]) == (2, 2)
        assert tuple(res["local/names"]) == ("data", "model")
        assert tuple(res["local1/shape"]) == (W.WORLD, 1)
    # ranks laid out row-major, as jax.make_mesh: data groups {0, 2}, {1, 3}
    assert [tuple(r["local/data_ranks"]) for r in world] == [
        (0, 2), (1, 3), (0, 2), (1, 3)]


@pytest.mark.parametrize("name,match", [
    ("local3", "world of 4 ranks does not split into model groups of 3"),
    ("production", r"holds 256 ranks; the world has 4")])
def test_mesh_refuses_a_shape_the_world_does_not_fill(world, name, match):
    import re
    for res in world:
        assert re.search(match, str(res[f"{name}/raised"]))


@pytest.mark.parametrize("make", [
    lambda: make_mesh((1,), ("data",), device="cpu"),
    lambda: make_local_mesh(device="cpu"),
    lambda: make_production_mesh(device="cpu")],
    ids=["mesh", "local", "production"])
def test_meshes_raise_without_a_process_group(make):
    """No mesh starts a process group, nor picks its backend, itself."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make()
    assert not torch.distributed.is_initialized()


def test_collectives_raise_without_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        compressed_psum(torch.ones(3), None)
    lm = LM(get_smoke("qwen3_8b").scaled(**F32), device="cpu")

    class Mesh:
        def get_group(self, axis):
            return None

    init, step = make_dp_shard_map_step(lm, AdamWConfig(), Mesh(),
                                        compress=False)
    batch = {k: torch.zeros((2, 4), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(RuntimeError, match="initialised process group"):
        step(init(init_train_state(lm).params), batch)


# -- compressed_psum ---------------------------------------------------------

@pytest.mark.parametrize("case", sorted(W.psum_cases()))
def test_compressed_psum_bit_equal_to_reference_under_vmap(world, case):
    g, r = W.psum_cases()[case]
    if r is None:
        fn = jax.vmap(lambda g: ref_compressed_psum(g, "data"),
                      axis_name="data")
        mean, res = fn(jnp.asarray(g))
    else:
        fn = jax.vmap(lambda g, r: ref_compressed_psum(g, "data", r),
                      axis_name="data")
        mean, res = fn(jnp.asarray(g), jnp.asarray(r))
    for rank, got in enumerate(world):
        np.testing.assert_array_equal(got[f"psum/{case}/mean"],
                                      np.asarray(mean[rank]))
        np.testing.assert_array_equal(got[f"psum/{case}/residual"],
                                      np.asarray(res[rank]))
    if case == "half":      # round half to even, as jnp.round
        assert list(np.asarray(mean[0]) * W.WORLD) == [
            127 - 4 + 10 + 0, 0 + 4 - 10 + 0, 2 + 6 + 12 - 2,
            2 - 6 + 12 + 2, 0 + 0 + 14 - 2, -2 + 8 - 14 + 2,
            -2 - 8 + 16 + 100, 126 - 126 + 16 - 100]


# -- the data-parallel step --------------------------------------------------

def test_exact_dp_step_matches_reference_single_device_step(world, ref):
    lm, params, p0 = ref
    b = W.batches(lm.cfg.vocab)[0]
    state = RefTrainState(params, ref_optim.init_state(params))
    want, metrics = jax.jit(ref_make_train_step(
        lm, ref_optim.AdamWConfig(**W.EXACT_OPT)))(state, jax_batch(b))
    want = {k: np.asarray(v) for k, v in want.params.items()}
    moved = max_diff(want, p0)
    assert moved > 10 * EXACT_TOL, moved       # the gate can fail
    for res in world:
        diff = max_diff(ref_names(res, "exact"), want)
        assert diff < EXACT_TOL, (diff, moved)
        for k in ("loss", "grad_norm"):
            assert abs(float(res[f"exact/0/{k}"]) - float(metrics[k])) \
                < EXACT_TOL, k


def test_exact_dp_step_matches_the_ports_train_step(world, ref):
    cfg = get_smoke("qwen3_8b").scaled(**F32)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_arrays(cfg, ref[2]))
    b = W.batches(cfg.vocab)[0]
    state, metrics = make_train_step(lm, AdamWConfig(**W.EXACT_OPT))(
        init_train_state(lm), {k: torch.from_numpy(v) for k, v in b.items()})
    want = {f"exact/params/{n}": p.detach().numpy()
            for n, p in state.params.items()}
    for res in world:
        got = {k: v for k, v in res.items() if k.startswith("exact/params/")}
        assert max_diff(got, want) < EXACT_TOL
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(res[f"exact/0/{k}"]) - float(metrics[k])) \
                < EXACT_TOL


@pytest.fixture(scope="module")
def compressed_oracle(ref):
    """Five compressed steps from the reference's pieces: the shard body
    of its make_dp_shard_map_step, the ranks stacked on a vmap axis."""
    lm, params, _ = ref
    ocfg = ref_optim.AdamWConfig(grad_clip=0.0, lr=W.LR)
    grads_of = jax.jit(jax.value_and_grad(ref_make_loss_fn(lm)))

    @jax.jit
    def reduce(grads, residual):
        def one(g, r):
            return jax.tree.map(
                lambda a, b: ref_compressed_psum(a, "data", b), g, r)
        out = jax.vmap(one, axis_name="data")(grads, residual)
        is_pair = lambda x: isinstance(x, tuple)      # noqa: E731
        return (jax.tree.map(lambda o: o[0][0], out, is_leaf=is_pair),
                jax.tree.map(lambda o: o[1], out, is_leaf=is_pair))

    update = jax.jit(lambda p, g, o: ref_optim.apply_updates(ocfg, p, g, o))
    opt = ref_optim.init_state(params)
    residual = jax.tree.map(
        lambda p: jnp.zeros((W.WORLD, *p.shape), jnp.float32), params)
    losses, norms = [], []
    for b in W.batches(lm.cfg.vocab)[1:]:
        per_rank = [grads_of(params, jax_batch(
            {k: v[W.rows_of(r, W.B)] for k, v in b.items()}))
            for r in range(W.WORLD)]
        losses.append(float(np.mean([float(l) for l, _ in per_rank],
                                    dtype=np.float32)))
        stacked = jax.tree.map(lambda *g: jnp.stack(g),
                               *[g for _, g in per_rank])
        grads, residual = reduce(stacked, residual)
        params, opt, m = update(params, grads, opt)
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: np.asarray(v) for k, v in params.items()}


def test_compressed_dp_losses_track_the_reference_pieces(world,
                                                         compressed_oracle):
    want, norms, _ = compressed_oracle
    for res in world:
        got = [float(res[f"compressed/{i}/loss"])
               for i in range(W.COMPRESSED_STEPS)]
        assert np.abs(np.subtract(got, want)).max() < LOSS_TOL, (got, want)
        np.testing.assert_allclose(
            [float(res[f"compressed/{i}/grad_norm"])
             for i in range(W.COMPRESSED_STEPS)], norms, rtol=GNORM_INT8_RTOL)


def test_compressed_dp_params_meet_the_reference_criteria(world, ref,
                                                          compressed_oracle):
    losses, _, want = compressed_oracle
    p0 = ref[2]
    for res in world:
        got = ref_names(res, "compressed")
        rel = max(float(np.abs(got[k] - want[k]).max()
                        / (np.abs(want[k] - p0[k]).max() + 1e-12))
                  for k in want)
        gap = abs(float(res[f"compressed/{W.COMPRESSED_STEPS - 1}/loss"])
                  - losses[-1])
        assert gap < LOSS_GAP and rel < REL_DRIFT, (gap, rel)
    # replicated parameters; each rank's own residual
    for res in world[1:]:
        for k, v in res.items():
            if k.startswith("compressed/params/"):
                np.testing.assert_array_equal(v, world[0][k])
    name = next(k for k in world[0] if k.startswith("compressed/residual/"))
    assert not np.array_equal(world[0][name], world[1][name])
    assert all(np.isfinite(v).all() for r in world for k, v in r.items()
               if k.startswith("compressed/residual/"))


def test_bf16_dp_steps_match_the_microbatched_step(world):
    """The limit chip_smoke.py's phase 16 (a) holds a world of more than
    one card to, rehearsed over gloo: the all-reduce adds the four float32
    gradients in another order than make_train_step's microbatch loop,
    and a last-bit change of an update can flip a bfloat16 rounding."""
    cfg = get_smoke(W.BF16_ARCH)
    lm = LM(cfg, device="cpu",
            generator=torch.Generator().manual_seed(W.BF16_SEED))
    step = make_train_step(lm, AdamWConfig(**W.BF16_OPT),
                           microbatches=W.WORLD)
    state = init_train_state(lm)
    p0 = torch.cat([p.detach().double().flatten()
                    for p in state.params.values()])
    norms = []
    for b in W.bf16_batches(cfg.vocab):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        norms.append(float(m["grad_norm"]))
    want = {n: p.detach().double() for n, p in state.params.items()}
    moved = float((torch.cat([w.flatten() for w in want.values()]) - p0)
                  .norm() / p0.norm())
    for res in world:
        rel = max(float((torch.from_numpy(res[f"bf16/params/{n}"]).double()
                         - w).norm() / w.norm()) for n, w in want.items())
        print(f"bf16 DP over {W.WORLD} ranks: largest relative L2 from the "
              f"microbatched step {rel:.3g} (limit {DP_WORLD_TOL:.3g}); the "
              f"steps move the parameters {moved:.3g} (relative L2)")
        assert rel <= DP_WORLD_TOL, rel
        np.testing.assert_allclose(
            [float(res[f"bf16/{i}/grad_norm"]) for i in range(W.BF16_STEPS)],
            norms, rtol=GNORM_RTOL)


# -- the cross-rank histograms -----------------------------------------------

@pytest.mark.parametrize("k", W.HIST_K)
def test_cross_rank_partition_histogram_equals_numpy(world, k):
    codes, _ = W.hist_codes()["hash"]
    want = np.bincount(ref_hash_partition(codes, k, salt=W.HIST_SALT),
                       minlength=k)
    one = partition_histogram(codes, k, salt=W.HIST_SALT, device="cpu")
    np.testing.assert_array_equal(one.numpy(), want)
    for res in world:
        got = res[f"hist/hash/{k}"]
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_codes", [50, 40])
def test_cross_rank_potential_counts_equal_numpy(world, num_codes):
    codes, _ = W.hist_codes()["counts"]
    want = np.bincount(codes, minlength=50)[:num_codes]
    one = sharded_potential_counts(codes, num_codes, device="cpu")
    np.testing.assert_array_equal(one.numpy(), want)
    for res in world:
        np.testing.assert_array_equal(res[f"hist/counts/{num_codes}"], want)
