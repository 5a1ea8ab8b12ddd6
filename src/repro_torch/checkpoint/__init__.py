"""Atomic, verified snapshots (the port of ``repro.checkpoint``)."""

from .checkpointer import Checkpointer, CorruptSnapshot

__all__ = ["Checkpointer", "CorruptSnapshot"]
