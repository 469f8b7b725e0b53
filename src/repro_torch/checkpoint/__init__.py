"""Checkpoints of the port, in the layout `repro.checkpoint` writes."""
