"""Checkpoint reading of the port (training itself comes with a later
slice)."""
