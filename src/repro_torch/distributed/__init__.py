"""Checkpointing (``checkpoint``) and fault tolerance (``ft``)."""
