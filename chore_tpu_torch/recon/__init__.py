"""Reconstruction of the port: point generation, losses, phase optimizer,
fitter (counterpart of ``chore_tpu.recon``)."""
