"""Executors: local interpreter, streaming aggregation, fragments."""
