"""Checkpointing (``checkpoint``) and the fault-tolerant training runner
(``fault_tolerance``) of the port."""
