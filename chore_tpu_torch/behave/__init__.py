"""BEHAVE on-disk readers of the port (sequence metadata)."""
