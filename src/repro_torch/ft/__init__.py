"""Fault-tolerance scenarios: failure injection, deterministic resume,
straggler mitigation.  The mechanisms live in train/trainer.py and
checkpoint/; this package hosts their test scenarios and docs.

(The port's copy: ``straggler.py`` is the reference's, verbatim.  The
partitioned build's shard report uses its ``flag_shard_stragglers``; the
trainer's crash and resume is ``repro_torch/train/trainer.py`` over
``repro_torch/checkpoint``.  Elastic restore onto another mesh waits for
sharding, ROADMAP.md queue 1 item 6.)
"""
