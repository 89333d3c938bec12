"""Checkpointing of the port's pytrees in the reference's file format."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, restore_pytree,
                                                 save_pytree)

__all__ = ["Checkpointer", "save_pytree", "restore_pytree"]
