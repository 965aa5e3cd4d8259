"""Fault-tolerant checkpointing (the reference's ``repro/checkpoint``).

Design points:

* **atomic commits** — writes land in ``step_<n>.tmp`` and are renamed only
  after every leaf + manifest is fsynced; a crash mid-write can never corrupt
  the latest checkpoint.
* **async** — `save_async` copies device tensors to the host (through the
  engine's staged download) then hands the IO to a background thread;
  training continues immediately (the join happens on the next save or at
  shutdown).
* **integrity** — every leaf carries a crc32; restore verifies before use.
* **one format for both packages** — the reference's file layout, keys
  and dtype names (bfloat16 as raw 2-byte words), with the port's
  per-layer LM parameters stored stacked under the reference's names.
* **retention** — keep the last K checkpoints, delete older ones only after
  a newer commit succeeded.
"""

from repro_torch.checkpoint.store import (CheckpointManager, available_steps,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "available_steps", "save_checkpoint",
           "restore_checkpoint"]
