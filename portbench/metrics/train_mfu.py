"""The training step's share of the cards' peak over the traced steps:
``flops.py``'s count of one image's forward and backward through the
published model, times the images of the traced steps (the global
batch's on several cards), over their device-traced window and the
cell's cards times the configuration's ``peak_flops``, %."""
from portbench import flops


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    images = t["steps"] * ctx.readings["images_per_step"]
    return 100.0 * flops.train_flops_per_image(ctx.cfg) * images \
        / t["window_s"] / (ctx.cfg["peak_flops"] * ctx.cell["chips"])
