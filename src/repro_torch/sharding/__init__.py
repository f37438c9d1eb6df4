"""Logical-axis sharding specs; the counterpart of ``repro.sharding``."""
