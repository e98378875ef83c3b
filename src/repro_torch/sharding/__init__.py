"""Partitioning of the port's params (tensor-parallel serving)."""
