"""Geometry and kernel ops of the port (counterpart of ``chore_tpu.ops``)."""
