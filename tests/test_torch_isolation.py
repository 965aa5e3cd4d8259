"""The port stands alone: no jax, no ``repro``, and an explicit device.

A child process with ``jax`` and ``repro`` blocked imports ``repro_torch``
and runs Figure 1 on the CPU, desummarizes it and aggregates from it, then
calls ``ops.dense_message`` and ``ops.rle_expand``, answers a COUNT
through a ``JoinServer`` in front of a ``JoinService``, and runs a
``partitions=2`` build, then builds a smoke ``LM``, takes one
``TokenBatcher`` batch from a ``JoinCorpus`` over Figure 1, and serves it
greedily through a ``ServeEngine`` with features from a
``RelationalFeatureProvider`` over a Figure-1 ``JoinService`` (and the
prompts through smoke zamba2, xlstm and Llama-3.2-Vision models, and
frames through a smoke HuBERT's encode step), then
trains it one ``Trainer`` step with a checkpoint (``ml_dtypes`` blocked
too), imports the mesh functions, the rank spawner and the
data-parallel step, and takes a full-size model's parameter specs from
the sharding rules and ``launch/specs.py``; a source
scan finds no jax, ``repro`` or ``ml_dtypes`` import under
``src/repro_torch/`` (the serving, partitioning, model, data, training,
checkpoint, mesh, data-parallel, sharding and placement modules
included) or in ``chip_smoke.py``; and a ``cuda`` entry point (a
``cuda`` mesh and a placement on one among them) without a card raises
instead of running on the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke
from repro_torch.core import engine
from repro_torch.data import JoinCorpus, TokenBatcher
from repro_torch.core.potentials import Factor
from repro_torch.dist.partition import partition_histogram
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models.model import LM
from repro_torch.relational.synth import figure1
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.summary import JoinService
from repro_torch.summary.algebra import SummaryFrame
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import repro_torch
from repro_torch.relational.synth import figure1
cat, q = figure1()
gj = repro_torch.GraphicalJoin(cat, q, device="cpu")
gfjs = gj.run()
rows = gj.desummarize(gfjs)
by_a = gj.aggregate("count", by=["A"], gfjs=gfjs)
import torch
from repro_torch.kernels import ops
msg = ops.dense_message(torch.ones((2, 3), dtype=torch.int32),
                        torch.full((3, 1), 7, dtype=torch.int32))
col = ops.rle_expand(torch.tensor([4, 5], dtype=torch.int32),
                     torch.tensor([2, 3], dtype=torch.int32), 3)
from repro_torch.serve import JoinServer
from repro_torch.summary import JoinService
server = JoinServer(JoinService(cat, device="cpu"))
n = server.frame(q).frame.count()
sharded = repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2).run()
assert sharded.num_partitions == 2 and sharded.join_size == n
import numpy as np
from repro_torch.configs import get_smoke
from repro_torch.data import JoinCorpus, TokenBatcher
from repro_torch.models.model import LM
from repro_torch.serve import (RelationalFeatureProvider, ServeConfig,
                               ServeEngine)
lm = LM(get_smoke("qwen3_8b").scaled(num_layers=2), device="cpu",
        generator=torch.Generator().manual_seed(0))
prov = RelationalFeatureProvider(JoinService(cat, device="cpu"), q,
                                 key_var="A", aggs={"n": "count"})
engine = ServeEngine(lm, ServeConfig(max_seq=12), feature_provider=prov,
                     device="cpu")
corpus = JoinCorpus.build(cat, q, vocab=lm.cfg.vocab, device="cpu")
batch = TokenBatcher(corpus, 2, 8, device="cpu").next_batch()
batch = engine.attach_features(batch, np.asarray(["a3", "a0"]))
out = engine.generate(batch, max_new=4)
assert out.shape == (2, 4) and ((out >= 0) & (out < lm.cfg.vocab)).all()
for arch in ("zamba2_2p7b", "xlstm_350m"):
    rec = LM(get_smoke(arch), device="cpu",
             generator=torch.Generator().manual_seed(0))
    got = ServeEngine(rec, ServeConfig(max_seq=12), device="cpu").generate(
        {"tokens": batch["tokens"]}, max_new=2)
    assert got.shape == (2, 2) and (got < rec.cfg.vocab).all()
vcfg = get_smoke("llama32_vision_11b")
vlm = LM(vcfg, device="cpu", generator=torch.Generator().manual_seed(0))
image = torch.zeros((2, vcfg.vlm.num_image_tokens, vcfg.vlm.vision_dim))
got = ServeEngine(vlm, ServeConfig(max_seq=12), device="cpu").generate(
    {"tokens": batch["tokens"], "vision": image}, max_new=2)
assert got.shape == (2, 2) and (got < vcfg.vocab).all()
from repro_torch.serve import make_serve_step
hub = LM(get_smoke("hubert_xlarge"), device="cpu",
         generator=torch.Generator().manual_seed(0))
enc = make_serve_step(hub, mode="prefill")(torch.zeros((2, 8, 512)))
assert enc.shape == (2, 8, hub.vocab_padded) and hub.device.type == "cpu"
import os, tempfile
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
ckpt = os.path.join(tempfile.mkdtemp(), "ckpt")
trainer = Trainer(lm, AdamWConfig(), TokenBatcher(corpus, 2, 8, device="cpu"),
                  TrainerConfig(steps=1, checkpoint_every=1,
                                checkpoint_dir=ckpt, log_every=1),
                  device="cpu")
state = trainer.run()
assert int(state.opt.step) == 1 and os.listdir(ckpt) == ["step_0000000001"]
assert trainer.metrics_log[0]["step"] == 1
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.train import compressed_psum, make_dp_shard_map_step
from types import SimpleNamespace
from repro_torch.dist import DEFAULT_RULES, constrain, param_specs, use
from repro_torch.launch import specs
from repro_torch.configs import get_config
flat = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
full = get_config("qwen3_8b")
axes = LM(full, device="meta").logical_axes()
rules = specs.arch_rules(full, flat)
assert param_specs(axes, flat, rules)["embed"] == ("model",)
assert param_specs(axes, flat, rules) == param_specs(axes, flat,
                                                     DEFAULT_RULES)
assert constrain(batch["tokens"]) is batch["tokens"]
assert not any(m in ("jax", "ml_dtypes")
               or m.startswith(("jax.", "repro.", "ml_dtypes."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(rows["A"]), by_a["A"].tolist(), by_a["count"].tolist(),
      msg[:, 0].tolist(), col.tolist(), n,
      tuple(batch["tokens"].shape), batch["features"].tolist())
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ("32 ['a3'] [32] [21, 21] [4, 4, 5] 32 "
                                  "(2, 8) [[32.0], [0.0]]")


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro|ml_dtypes)(?:[.\s]|$)",
                     re.M)


def test_source_imports_neither_jax_nor_reference():
    """Nor ``ml_dtypes``, which comes with jax: the card's machine has
    neither."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {str(f.relative_to(ROOT / "src" / "repro_torch"))
             for f in files[:-1]}
    assert {"obs/check.py", "summary/cache.py", "summary/incremental.py",
            "summary/msgcache.py", "summary/service.py",
            "serve/server.py", "serve/__init__.py", "dist/partition.py",
            "dist/actions.py", "dist/__init__.py", "ft/straggler.py",
            "models/config.py", "models/layers.py", "models/flash.py",
            "models/attention.py", "models/blocks.py", "models/model.py",
            "models/moe.py", "models/ssm.py", "models/xlstm.py",
            "core/oracle.py", "core/baselines.py",
            "configs/__init__.py", "configs/qwen3_8b.py",
            "serve/engine.py", "data/pipeline.py", "launch/serve.py",
            "interop.py", "train/__init__.py", "train/optim.py",
            "train/train_step.py", "train/trainer.py",
            "checkpoint/__init__.py", "checkpoint/store.py",
            "launch/train.py", "launch/mesh.py",
            "launch/ranks.py", "launch/specs.py", "dist/sharding.py",
            "dist/act_sharding.py", "launch/op_analysis.py",
            "launch/dryrun.py", "launch/roofline.py",
            "launch/inspect_cell.py"} <= names
    bad = {str(f.relative_to(ROOT)): _IMPORT.findall(f.read_text())
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


@pytest.mark.parametrize("entry", ["facade", "generate", "desummarize",
                                   "build_factor", "segment_weighted_sum",
                                   "group_runs_device", "summary_frame",
                                   "maybe_dense_message", "join_service",
                                   "partition_histogram",
                                   "partitioned_facade", "lm", "moe_lm",
                                   "hybrid_lm", "ssm_lm",
                                   "serve_engine", "join_corpus",
                                   "token_batcher", "trainer", "mesh",
                                   "local_mesh", "placement"])
def test_cuda_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat, q = figure1()
    if entry in ("facade", "partitioned_facade"):
        kw = dict(partitions=2) if entry == "partitioned_facade" else {}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.GraphicalJoin(cat, q, **kw)
        return
    gj = repro_torch.GraphicalJoin(cat, q, device="cpu")
    gfjs = gj.run()
    ones = np.ones(3, np.int64)
    calls = {
        "generate": lambda: engine.generate_gfjs(gj.generator,
                                                 gj.enc.domains),
        "desummarize": lambda: engine.desummarize(gfjs),
        "build_factor": lambda: engine.build_factor({"A": ones}, {"A": 2}),
        "segment_weighted_sum": lambda: engine.segment_weighted_sum(
            np.zeros(3, np.int32), ones, ones, 1),
        "group_runs_device": lambda: engine.group_runs_device(ones),
        "summary_frame": lambda: SummaryFrame.of(gfjs),
        "maybe_dense_message": lambda: engine.maybe_dense_message(
            Factor(("P", "V"), np.zeros((1, 2), np.int64), ones[:1],
                   ones[:1], (1, 1)), "V", ones[:1]),
        "join_service": lambda: JoinService(cat),
        "partition_histogram": lambda: partition_histogram(ones, 2),
        "lm": lambda: LM(get_smoke("qwen3_8b")),
        "moe_lm": lambda: LM(get_smoke("deepseek_v2_236b")),
        "hybrid_lm": lambda: LM(get_smoke("zamba2_2p7b")),
        "ssm_lm": lambda: LM(get_smoke("xlstm_350m")),
        "serve_engine": lambda: ServeEngine(
            LM(get_smoke("qwen3_8b"), device="cpu"), ServeConfig(8)),
        "join_corpus": lambda: JoinCorpus.build(cat, q, vocab=256),
        "token_batcher": lambda: TokenBatcher(
            JoinCorpus(gfjs, vocab=256), 2, 8),
        "trainer": lambda: Trainer(
            LM(get_smoke("qwen3_8b"), device="cpu"), AdamWConfig(),
            TokenBatcher(JoinCorpus(gfjs, vocab=256), 2, 8, device="cpu"),
            TrainerConfig()),
        "mesh": lambda: make_mesh((1,), ("data",)),
        "local_mesh": lambda: make_local_mesh(),
        "placement": lambda: place_on_a_cuda_mesh(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def place_on_a_cuda_mesh():
    """``place_params`` onto a ``"cuda"`` mesh (a stand-in: building a
    real one raises first) by the rules' placements."""
    from types import SimpleNamespace
    from repro_torch.launch.specs import Sharding, place_params
    lm = LM(get_smoke("qwen3_8b"), device="cpu")
    mesh = SimpleNamespace(device_type="cuda", mesh_dim_names=("data",))
    place_params(lm, {n: Sharding(mesh, (), ())
                      for n, _ in lm.named_parameters()})
