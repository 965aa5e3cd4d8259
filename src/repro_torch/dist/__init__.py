"""Distribution layer: logical-axis sharding rules, activation-sharding
context, and the hash-partitioned Graphical Join execution layer.

Models declare *logical* axes ("embed", "heads", "ff", ...) per parameter
(``repro_torch/models/layers.py::declare``); :mod:`repro_torch.dist.sharding`
maps those to mesh specs and DTensor placements so model code never
mentions mesh axes, and :mod:`repro_torch.dist.act_sharding` holds the
activation-sharding context.  ``launch/specs.py`` places a model by them,
and the sharded train step is ``train_step.make_train_step`` on the
placed parameters.  :mod:`repro_torch.dist.partition` carries the GJ-side
layer (DESIGN.md §15): hash-partitioning of encoded potentials on a
planned partition variable, partition and potential histograms on one
torch device or summed across the ranks of a mesh axis, and parallel
desummarization of both monolithic and sharded summaries;
:mod:`repro_torch.dist.actions` the process-pool shard executor and its
wire format (DESIGN.md §17).  The explicit half of data parallelism, the
data-parallel train step and its compressed all-reduce, is in
:mod:`repro_torch.train.train_step`.

Submodule re-exports resolve lazily (PEP 562), as in the reference.
"""

_SHARDING = {"ShardingRules", "DEFAULT_RULES", "SP_FSDP_RULES", "param_specs"}
_ACT = {"constrain", "use"}
_PARTITION = {"PartitionScheme", "choose_partition_fold",
              "choose_partition_var", "fold_loads", "hash_partition",
              "hash_partition_device", "parallel_desummarize",
              "partition_counts", "partition_encoded", "partition_histogram",
              "sharded_potential_counts"}
_ACTIONS = {"ShardBuildAction", "ShardBuildResult", "DispatchOutcome",
            "ProcessShardExecutor", "encode_action", "decode_action",
            "encode_result", "decode_result", "perform_action",
            "run_shard_action", "shared_shard_executor",
            "shutdown_shared_executor"}

__all__ = sorted(_SHARDING | _ACT | _PARTITION | _ACTIONS)


def __getattr__(name):
    import importlib
    if name in _SHARDING:
        return getattr(importlib.import_module("repro_torch.dist.sharding"),
                       name)
    if name in _ACT:
        return getattr(importlib.import_module(
            "repro_torch.dist.act_sharding"), name)
    if name in _PARTITION:
        return getattr(importlib.import_module("repro_torch.dist.partition"),
                       name)
    if name in _ACTIONS:
        return getattr(importlib.import_module("repro_torch.dist.actions"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
