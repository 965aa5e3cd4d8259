"""The placement half of parallelism against the reference, on the CPU.

* The rules are pure functions of names and sizes, so they are held
  exactly: for every architecture at full size (the port's ``LM`` on
  ``meta``, the reference's abstract), under ``DEFAULT_RULES``,
  ``SP_FSDP_RULES`` and ``arch_rules``, on the meshes (16, 16), (2, 16,
  16) and (4, 2), each parameter's spec equals the reference's
  ``PartitionSpec`` (computed in-process on ``jax.sharding.AbstractMesh``)
  less the leading ``"layers"`` entries its stacks add (asserted ``None``),
  and ``LM.logical_axes()`` equals the reference's axes less those
  entries; so do ``batch_shardings``, ``cache_shardings`` (on
  ``abstract_caches``), ``state_shardings`` and ``build_cell``'s.  The
  port's meshes come from a fake process group of 512 ranks, which the
  module's fixture destroys afterwards.
* ``placements`` gives the local shapes JAX's ``shard_shape`` gives, and
  raises on a spec whose mesh axes DTensor would lay out otherwise;
  ``constrain`` is the identity with no context, redistributes a DTensor
  under ``use`` and raises for a plain tensor there.
* One spawned 4-rank gloo world (``tests/torch_sharding_world.py``) runs
  the sharded step on a (2, 2) ``("data", "model")`` mesh: the qwen3_8b
  smoke model of ``tests/test_dist.py``'s GSPMD test (2 layers, d 64,
  4 / 2 heads, float32, 8 x 16, ``grad_clip=0``, the warmup's first step
  at the full lr) placed by ``arch_rules``, alone and under the sequence-
  parallel activation constraint.  Its parameters are held within 2e-5
  (that test's gate) of the reference's single-device ``make_train_step``
  run here on the same weights, and of the port's; the loss and
  ``grad_norm`` too; and the step moves the parameters more than ten
  times the gate, so that the gate can fail.  Beside it, one rank on a
  (1, 1) mesh holds two placed steps bit for bit to the plain ones, on
  the dense and the online attention path.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.dist import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.configs import get_smoke
from repro_torch.dist.act_sharding import constrain, current, use
from repro_torch.dist.sharding import (DEFAULT_RULES, SP_FSDP_RULES,
                                       param_specs, placements)
from repro_torch.interop import lm_reference_name, lm_state_dict_from_arrays
from repro_torch.launch import specs
from repro_torch.models.attention import KVCache
from repro_torch.models.model import LM
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

import torch_sharding_world as W

GATE = 2e-5                 # tests/test_dist.py's GSPMD gate
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
RULES = ("default", "sp_fsdp", "arch")
DECODE_ARCHS = [a for a in ARCH_IDS if "decode_32k" in applicable_shapes(a)]
CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(a)]


@pytest.fixture(scope="module")
def meshes():
    """name -> (the port's DeviceMesh over a fake process group of 512
    ranks, the reference's AbstractMesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {name: (init_device_mesh("cpu", shape, mesh_dim_names=axes),
                      AbstractMesh(shape, axes))
               for name, (shape, axes) in MESHES.items()}
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def port_lm(arch: str) -> LM:
    return LM(get_config(arch), device="meta")


@functools.lru_cache(maxsize=None)
def ref_lm(arch: str) -> RefLM:
    return RefLM(ref_get_config(arch))


def stacked_of(lm: LM) -> dict:
    """state-dict name -> (reference name, the number of stacked axes)."""
    out = {}
    for n, _ in lm.named_parameters():
        ref, idx = lm_reference_name(n, lm.reference_prefixes)
        out[n] = (ref, len(idx))
    return out


def strip(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def ref_tail(spec, stacked: int, ndim: int) -> tuple:
    """The reference's spec for one of the port's per-layer tensors: its
    stacked entries asserted None, the rest padded to ``ndim``."""
    spec = tuple(spec) + (None,) * (stacked + ndim - len(tuple(spec)))
    assert spec[:stacked] == (None,) * stacked, spec
    return spec[stacked:]


def rules_pair(which: str, arch: str, pmesh, amesh):
    if which == "default":
        return DEFAULT_RULES, ref_sharding.DEFAULT_RULES
    if which == "sp_fsdp":
        return SP_FSDP_RULES, ref_sharding.SP_FSDP_RULES
    return (specs.arch_rules(get_config(arch), pmesh),
            ref_specs.arch_rules(ref_get_config(arch), amesh))


def assert_param_specs_equal(lm, port: dict, ref: dict) -> None:
    names = stacked_of(lm)
    assert set(port) == set(names)
    assert {r for r, _ in names.values()} == set(ref)
    for n, (r, k) in names.items():
        assert strip(port[n]) == strip(ref_tail(ref[r], k, 0)), (n, r)


def assert_sharding(sh, pmesh, spec) -> None:
    assert sh.mesh is pmesh
    assert sh.spec == tuple(spec)
    assert sh.placements == placements(tuple(spec), pmesh)


# -- logical axes and parameter specs -----------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_are_the_references_less_the_stacked_axes(arch):
    lm = port_lm(arch)
    axes, ref = lm.logical_axes(), ref_lm(arch).logical_axes()
    assert all(p.is_meta for p in lm.parameters())      # nothing allocated
    assert list(axes) == [n for n, _ in lm.named_parameters()]
    seen = set()
    for n, (r, k) in stacked_of(lm).items():
        assert ref[r][:k] == ("layers",) * k, (n, r)
        assert ref[r][k:] == axes[n], (n, r)
        assert len(axes[n]) == lm.get_parameter(n).ndim
        seen.add(r)
    assert seen == set(ref)


@pytest.mark.parametrize("which", RULES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(meshes, arch, mesh_name, which):
    pmesh, amesh = meshes[mesh_name]
    rules, ref_rules = rules_pair(which, arch, pmesh, amesh)
    assert dict(rules.rules) == dict(ref_rules.rules)
    lm = port_lm(arch)
    assert_param_specs_equal(
        lm, param_specs(lm.logical_axes(), pmesh, rules),
        ref_sharding.param_specs(ref_lm(arch).logical_axes(), amesh,
                                 ref_rules))


def test_arch_rules_shard_head_dim_where_heads_do_not_divide(meshes):
    """The reference's own example: gemma3's 8 heads on a 16-way axis."""
    rules = specs.arch_rules(get_config("gemma3_4b"), meshes["16x16"][0])
    assert rules.rules["head"] == ("model",)
    assert rules.rules["heads"] is None and rules.rules["kv_heads"] is None


# -- batch, cache and state shardings -----------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_match_the_reference(meshes, arch, mesh_name):
    pmesh, amesh = meshes[mesh_name]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for seq, batch, kind in SHAPES.values():
        for labels in (True, False):
            got = specs.batch_struct(cfg, batch, seq, labels=labels)
            want = ref_specs.batch_struct(rcfg, batch, seq, labels=labels)
            assert list(got) == list(want)
            spec_of = specs.batch_shardings(cfg, pmesh, batch)
            ref_of = ref_specs.batch_shardings(rcfg, amesh, batch)
            for k, t in got.items():
                assert t.is_meta and tuple(t.shape) == want[k].shape
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
                assert_sharding(spec_of(t), pmesh, tuple(ref_of(want[k]).spec))


class Leaf:
    """One port cache tensor, the stacks around it and its sharding."""

    def __init__(self, t, stacked, sharding):
        self.shape, self.stacked, self.sharding = (tuple(t.shape), stacked,
                                                   sharding)


def cache_pairs(port, ref, gqa=False):
    """(port Leaf, reference leaf, heads-major GQA K/V?) for every tensor
    of one segment's caches, walked together: a list of layers stands for
    the reference's leading stacked axis, a dataclass for its
    NamedTuple."""
    if isinstance(port, Leaf):
        yield port, ref, gqa and len(port.shape) == 4
    elif isinstance(port, list):
        for layer in port:
            yield from cache_pairs(layer, ref)
    elif isinstance(port, tuple):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            yield from cache_pairs(a, b)
    elif dataclasses.is_dataclass(port):
        assert [f.name for f in dataclasses.fields(port)] == list(ref._fields)
        for f in dataclasses.fields(port):
            yield from cache_pairs(getattr(port, f.name),
                                   getattr(ref, f.name),
                                   isinstance(port, KVCache)
                                   and f.name in ("k", "v"))


# the port's GQA cache is heads-major, [B, KV, S, hd]; the reference's
# [B, S, KV, hd]
GQA_PERM = (0, 2, 1, 3)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_shardings_match_the_reference(meshes, arch, mesh_name):
    pmesh, amesh = meshes[mesh_name]
    lm, rlm = port_lm(arch), ref_lm(arch)
    for name in applicable_shapes(arch):
        seq, batch, kind = SHAPES[name]
        if kind != "decode":
            continue
        caches = specs.abstract_caches(lm, batch, seq)
        metas = []
        specs.map_caches(lambda t, k: metas.append(t.is_meta), caches)
        assert metas and all(metas)
        spec_of = specs.cache_shardings(pmesh, batch)
        got = specs.map_caches(lambda t, k: Leaf(t, k, spec_of(t, k)),
                               caches)
        ref_caches = ref_specs.abstract_caches(rlm, batch, seq)
        want = jax.tree.map(ref_specs.cache_shardings(amesh, batch),
                            ref_caches)
        assert len(got) == len(want)
        n = 0
        for g, w, rc in zip(got, want, ref_caches):
            for (leaf, ws, gqa), (_, rleaf, _) in zip(cache_pairs(g, w),
                                                     cache_pairs(g, rc)):
                n += 1
                k, perm = leaf.stacked, GQA_PERM if gqa else range(
                    len(leaf.shape))
                assert tuple(leaf.shape[i] for i in perm) == \
                    rleaf.shape[k:]
                assert tuple(leaf.sharding.spec[i] for i in perm) == \
                    ref_tail(ws.spec, k, len(leaf.shape)), (name, k)
                assert leaf.sharding.placements == placements(
                    leaf.sharding.spec, pmesh)
        assert n > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_shardings_match_the_reference(meshes, arch, mesh_name):
    pmesh, amesh = meshes[mesh_name]
    lm, rlm = port_lm(arch), ref_lm(arch)
    rules, ref_rules = rules_pair("arch", arch, pmesh, amesh)
    got = specs.state_shardings(lm, pmesh, rules)
    want = ref_specs.state_shardings(rlm, amesh, ref_rules)
    for part in ("m", "v"):
        assert set(getattr(want.opt, part)) == set(want.params)
    for tree, ref_tree in ((got.params, want.params),
                           (got.opt.m, want.opt.m), (got.opt.v, want.opt.v)):
        for sh in tree.values():
            assert sh.placements == placements(sh.spec, pmesh)
        assert_param_specs_equal(
            lm, {n: sh.spec for n, sh in tree.items()},
            {r: sh.spec for r, sh in ref_tree.items()})
    assert_sharding(got.opt.step, pmesh, tuple(want.opt.step.spec))
    # the abstract state: float32 moments like the parameters, on meta
    state = specs.abstract_state(lm)
    ref_state = ref_specs.abstract_state(rlm)
    assert state.params.keys() == state.opt.m.keys() == got.params.keys()
    for n, (r, k) in stacked_of(lm).items():
        p, m = state.params[n], state.opt.m[n]
        assert m.is_meta and m.dtype == torch.float32 and m.shape == p.shape
        assert tuple(p.shape) == ref_state.params[r].shape[k:]
    assert state.opt.step.is_meta and state.opt.step.dtype == torch.int32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell_matches_the_reference(meshes, arch, shape):
    pmesh, amesh = meshes["16x16"]
    fn, args, shardings, lm, cfg, kind = specs.build_cell(arch, shape, pmesh)
    rfn, rargs, rshardings, rlm, rcfg, rkind = ref_specs.build_cell(
        arch, shape, amesh)
    assert kind == rkind and len(args) == len(rargs) == len(shardings)
    assert cfg.max_seq == rcfg.max_seq and cfg.name == rcfg.name
    assert all(p.is_meta for p in lm.parameters())
    if kind == "train":
        st_sh, b_sh = shardings
        ref_st, ref_b = rshardings
        assert_param_specs_equal(
            lm, {n: sh.spec for n, sh in st_sh.params.items()},
            {r: sh.spec for r, sh in ref_st.params.items()})
        assert args[0].params.keys() == st_sh.params.keys()
    else:
        p_sh, b_sh = shardings[:2]
        ref_b = rshardings[1]
        assert_param_specs_equal(
            lm, {n: sh.spec for n, sh in p_sh.items()},
            {r: sh.spec for r, sh in rshardings[0].items()})
        assert args[0] == dict(lm.named_parameters())
    if kind == "decode":
        assert_sharding(b_sh, pmesh, tuple(ref_b.spec))
        assert tuple(args[1].shape) == rargs[1].shape
        if cfg.family == "vlm":
            assert_sharding(shardings[3], pmesh, tuple(rshardings[3].spec))
    else:
        assert sorted(b_sh) == sorted(ref_b)
        for k, sh in b_sh.items():
            assert_sharding(sh, pmesh, tuple(ref_b[k].spec))
            assert tuple(args[1][k].shape) == rargs[1][k].shape
    with pytest.raises(ValueError, match="model's parameters"):
        fn({}, *args[1:]) if kind != "train" else fn(
            args[0]._replace(params={}), args[1])


# -- placements and the activation context ------------------------------------

@pytest.mark.parametrize("mesh_name,spec", [
    ("4x2", ("data",)), ("4x2", (None, "model")), ("4x2", ("model", "data")),
    ("4x2", (("data", "model"),)), ("16x16", (None, None, "model")),
    ("2x16x16", (("pod", "data"), "model")), ("2x16x16", ("model", "pod")),
    ("2x16x16", ())])
def test_placements_give_jax_local_shapes(meshes, mesh_name, spec):
    from torch.distributed.tensor import distribute_tensor
    pmesh, amesh = meshes[mesh_name]
    shape = (64, 32, 16)
    pl = placements(spec, pmesh)
    assert len(pl) == pmesh.ndim
    local = distribute_tensor(torch.zeros(shape), pmesh, pl).to_local()
    assert tuple(local.shape) == NamedSharding(amesh, P(*spec)).shard_shape(
        shape)


@pytest.mark.parametrize("spec,match", [
    ((("data", "pod"),), "not in the mesh's order"),
    (("data", "data"), "twice"),
    ((None, "expert"), "no axis 'expert'")])
def test_placements_refuse_what_dtensor_would_lay_out_otherwise(meshes, spec,
                                                                match):
    with pytest.raises(ValueError, match=match):
        placements(spec, meshes["2x16x16"][0])


def test_constrain_is_the_identity_without_a_context(meshes):
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = torch.ones(4, 2)
    assert current() is None and constrain(x) is x
    xd = distribute_tensor(x, meshes["4x2"][0], [Replicate(), Replicate()])
    assert constrain(xd) is xd


def test_constrain_under_use_redistributes_a_dtensor(meshes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    pmesh = meshes["4x2"][0]
    xd = distribute_tensor(torch.zeros(8, 6), pmesh, [Shard(0), Replicate()])
    seen = []
    with use(pmesh, (None, "model")):
        y = constrain(xd)
        t = threading.Thread(target=lambda: seen.append(current()))
        t.start()
        t.join()
        with use(pmesh, ("data",)):
            assert current()[1] == ("data",)
        assert current() == (pmesh, (None, "model"))
    assert current() is None and seen == [None]      # per thread
    assert tuple(y.placements) == (Replicate(), Shard(1))
    assert tuple(y.to_local().shape) == (8, 3)


def test_constrain_under_a_context_raises_for_a_plain_tensor(meshes):
    with use(meshes["4x2"][0], ("data",)):
        with pytest.raises(TypeError, match="DTensor"):
            constrain(torch.zeros(8, 6))


def test_single_device_forward_under_a_context_raises():
    """The model's constraints hold it to the context: no quiet gather."""
    cfg = get_smoke("qwen3_8b").scaled(**W.SMOKE)
    lm = LM(cfg, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with use(object(), ("data",)):
        with pytest.raises(TypeError, match="DTensor"):
            lm(tokens)
        with pytest.raises(TypeError, match="DTensor"):
            lm.prefill(tokens, 8)


# -- the sharded train step on a (2, 2) mesh ----------------------------------

@pytest.fixture(scope="module")
def ref():
    cfg = ref_get_smoke("qwen3_8b").scaled(**W.SMOKE)
    lm = RefLM(cfg)
    params = lm.init(jax.random.key(0))
    return lm, params, {k: np.asarray(v, np.float32)
                        for k, v in params.items()}


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_world")
    np.savez(out / "weights.npz", **ref[2])
    return W.run_world(out, out / "weights.npz")


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ref_step(ref):
    """The reference's single-device step on the world's weights and
    batch: (parameters by the port's names, loss, grad_norm, movement)."""
    lm, params, p0 = ref
    b = {k: jnp.asarray(v) for k, v in W.batch(lm.cfg.vocab).items()}
    state = RefTrainState(params, ref_optim.init_state(params))
    out, metrics = jax.jit(ref_make_train_step(
        lm, ref_optim.AdamWConfig(**W.OPT)))(state, b)
    want = {k: np.asarray(v, np.float32) for k, v in out.params.items()}
    moved = max(float(np.abs(want[k] - p0[k]).max()) for k in want)
    port = LM(get_smoke("qwen3_8b").scaled(**W.SMOKE), device="meta")
    by_port = {}
    for n, _ in port.named_parameters():
        r, idx = lm_reference_name(n, port.reference_prefixes)
        by_port[n] = want[r][idx]
    return by_port, float(metrics["loss"]), float(metrics["grad_norm"]), \
        moved


@pytest.fixture(scope="module")
def port_step(ref):
    cfg = get_smoke("qwen3_8b").scaled(**W.SMOKE)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_arrays(cfg, ref[2]))
    state, m = make_train_step(lm, AdamWConfig(**W.OPT))(
        init_train_state(lm),
        {k: torch.from_numpy(v) for k, v in W.batch(cfg.vocab).items()})
    return ({n: p.detach().numpy() for n, p in state.params.items()},
            float(m["loss"]), float(m["grad_norm"]))


def max_diff(res: dict, case: str, want: dict) -> float:
    pre = f"{case}/params/"
    got = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
    assert got.keys() == want.keys()
    return max(float(np.abs(got[n] - want[n]).max()) for n in want)


@pytest.mark.parametrize("case", W.CASES)
def test_sharded_step_matches_the_reference_single_device_step(world,
                                                               ref_step,
                                                               case):
    want, loss, gnorm, moved = ref_step
    assert moved > 10 * GATE, moved                 # the gate can fail
    for res in world:
        diff = max_diff(res, case, want)
        print(f"{case}: sharded step {diff:.3g} from the reference's "
              f"single-device step (gate {GATE}); the step moves the "
              f"parameters {moved:.3g}")
        assert diff < GATE, (diff, moved)
        assert abs(float(res[f"{case}/loss"]) - loss) < GATE
        assert abs(float(res[f"{case}/grad_norm"]) - gnorm) < GATE


@pytest.mark.parametrize("case", W.CASES)
def test_sharded_step_matches_the_ports_single_device_step(world, port_step,
                                                           case):
    want, loss, gnorm = port_step
    for res in world:
        assert max_diff(res, case, want) < GATE
        assert abs(float(res[f"{case}/loss"]) - loss) < GATE
        assert abs(float(res[f"{case}/grad_norm"]) - gnorm) < GATE
        assert float(res[f"{case}/lr"]) == pytest.approx(3e-4, rel=1e-6)


@pytest.mark.parametrize("case", W.CASES)
def test_sharded_state_keeps_the_rules_placements(world, case):
    for res in world:
        assert bool(res[f"{case}/placed_as_rules"])
        # the heads, kv heads, ff and vocab axes: 16 of 25 parameters
        assert int(res[f"{case}/sharded"]) == 16
    for res in world[1:]:          # every rank holds the same model
        for k, v in res.items():
            if k.startswith(f"{case}/params/"):
                np.testing.assert_array_equal(v, world[0][k])


def test_constrain_redistributes_values_across_ranks(world):
    x = np.arange(W.B * 6, dtype=np.float32).reshape(W.B, 6)
    for res in world:
        assert bool(res["act/same"])
        assert list(res["act/placements"]) == ["R", "S(1)"]
        assert tuple(res["act/local_shape"]) == (W.B, 3)
        np.testing.assert_array_equal(res["act/full"], x)


@pytest.mark.parametrize("B,S", W.ONE_SHAPES)
def test_placed_step_on_one_rank_is_bit_equal_to_the_plain_step(runs, B, S):
    """A (1, 1) mesh: two placed steps, parameters and losses bit for bit
    the plain steps' (smoke phase 17 (a) at world 1), on the dense and the
    online attention path."""
    one = runs[1]
    names = [k for k in one if k.startswith(f"{S}/plain/params/")]
    assert len(names) == 25
    for k in names:
        np.testing.assert_array_equal(one[k.replace("/plain/", "/placed/")],
                                      one[k], err_msg=k)
    for i in range(W.ONE_STEPS):
        assert one[f"{S}/placed/loss{i}"] == one[f"{S}/plain/loss{i}"]
