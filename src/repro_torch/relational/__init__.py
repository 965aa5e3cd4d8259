"""Relational substrate: tables, queries, encoding, synthetic data (numpy copies)."""
