"""The dispatch thread's own time in ``Trainer.train_step``: the mean of
the harness's span around each call in the window, ms."""


def read(ctx):
    return ctx.mean_ms("train_step")
