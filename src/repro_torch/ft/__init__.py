"""Fault-tolerance scenarios: failure injection, deterministic resume,
straggler mitigation.  The mechanisms live in train/trainer.py and
checkpoint/; this package hosts their test scenarios and docs.

(The port's copy: ``straggler.py`` is the reference's, verbatim.  The
partitioned build's shard report uses its ``flag_shard_stragglers``; the
trainer and checkpoint store it names are not ported yet, ROADMAP.md
queue 1, the LM, training and serving stack.)
"""
