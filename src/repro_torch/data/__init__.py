"""GJ-fed data pipeline: relational corpus -> GFJS -> range-sharded
desummarization -> token batches on the device."""

from repro_torch.data.pipeline import JoinCorpus, TokenBatcher

__all__ = ["JoinCorpus", "TokenBatcher"]
