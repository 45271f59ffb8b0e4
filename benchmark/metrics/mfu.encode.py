"""The whole encode step's share of the stated precision's peak: the model's
operations (work/<config>.py) for the images the traced half did, over
the half's host time."""


def read(ctx):
    return ctx.mfu("encode")
