"""The port's dry run (``launch/dryrun.py``) over the whole grid, on the
CPU, against the reference's shardings.

Every arch x applicable shape cell (train, prefill or encode, and decode,
for all ten architectures in ``configs/``) is built at full width and
depth one unit (``dryrun.unit_layers``: the fewest layers that hold one
of each of the family's blocks), placed on the 16 x 16 production mesh
of a fake world of 256 ranks on meta tensors, and run once under the op
counter, with no ``.err``.  That covers the cells that failed before
this slice: the MoE dispatch (granite, DeepSeek-V2), MLA's full
attention, the SSD and xLSTM masks and states, gemma3's and
Llama-3.2-Vision's train cells at the loss (their logits arrive as a
pending sum), prefill on placed caches.  Each cell's per-device argument
bytes (parameters, optimizer state, batch and caches) equal the sum of
the reference's ``NamedSharding.shard_shape`` bytes for the same cell on
``AbstractMesh`` exactly.  The CLI writes a ``.json`` per cell and a
``.json.err`` for a cell that fails.  The multi-pod and ``sp_fsdp`` runs
are in ``tests/test_torch_roofline.py``, so that ``--dist loadfile``
spreads the two files.
"""

import json

import pytest
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes
from repro_torch.launch import dryrun

from torch_dryrun_ref import reference_argument_bytes, unit

CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(a)]
KEYS = {"arch", "shape", "mesh", "kind", "devices", "seconds", "flops",
        "bytes_accessed", "collectives", "memory", "params",
        "active_params"}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_cell_places_and_runs_on_the_16x16_mesh(arch, shape):
    res = dryrun.run_cell(arch, shape, False,
                          overrides=dict(num_layers=unit(arch)))
    assert not dist.is_initialized()            # the fake world is gone
    assert KEYS <= set(res)
    assert res["devices"] == 256 and res["mesh"] == "pod16x16"
    assert res["kind"] == SHAPES[shape][2]
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    coll = res["collectives"]
    assert coll["total"] == sum(coll[k] for k in dryrun.COLLECTIVE_KINDS)
    assert res["memory"]["output_size_in_bytes"] > 0
    # per device: every FLOP counted is a share of the global count
    assert res["flops"] < res["flops_global"]
    assert res["memory"]["argument_size_in_bytes"] == \
        reference_argument_bytes(arch, shape, False, unit(arch))


def test_cli_writes_a_json_per_cell_and_an_err_for_a_failure(tmp_path,
                                                             monkeypatch):
    out = tmp_path / "dry"
    argv = ["dryrun", "--arch", "qwen3_8b", "--shape", "decode_32k",
            "--mesh", "single", "--out", str(out)]
    monkeypatch.setattr("sys.argv", argv)
    dryrun.main()
    res = json.loads((out / "qwen3_8b--decode_32k--pod16x16.json")
                     .read_text())
    assert res["arch"] == "qwen3_8b" and res["num_layers"] == 36

    def fail(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "run_cell", fail)
    monkeypatch.setattr("sys.argv", argv + ["--force"])
    dryrun.main()
    err = json.loads((out / "qwen3_8b--decode_32k--pod16x16.json.err")
                     .read_text())
    assert err["error"] == "RuntimeError: planted" and err["traceback"]
