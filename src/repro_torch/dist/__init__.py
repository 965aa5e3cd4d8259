"""Distribution layer: the hash-partitioned Graphical Join execution layer.

:mod:`repro_torch.dist.partition` carries the GJ-side layer (DESIGN.md
§15): hash-partitioning of encoded potentials on a planned partition
variable, partition and potential histograms on one torch device, and
parallel desummarization of both monolithic and sharded summaries;
:mod:`repro_torch.dist.actions` the process-pool shard executor and its
wire format (DESIGN.md §17).

The reference's package also carries the model-sharding rules
(``repro/dist/sharding.py``, ``act_sharding.py``).  They need more than
one device and are not ported yet (ROADMAP.md queue 1 item 6: sharding,
with the data-parallel train step), so asking for their names raises
:class:`AttributeError` naming that item.
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

__all__ = sorted(_PARTITION | _ACTIONS)


def __getattr__(name):
    import importlib
    if name in _SHARDING or name in _ACT:
        raise AttributeError(
            f"{name!r} belongs to the model-sharding rules, which are not "
            "ported yet (ROADMAP.md queue 1 item 6: sharding and "
            "everything that needs more than one device)")
    if name in _PARTITION:
        return getattr(importlib.import_module("repro_torch.dist.partition"),
                       name)
    if name in _ACTIONS:
        return getattr(importlib.import_module("repro_torch.dist.actions"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
