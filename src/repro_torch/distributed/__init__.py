"""Checkpointing of the port (``checkpoint``)."""
