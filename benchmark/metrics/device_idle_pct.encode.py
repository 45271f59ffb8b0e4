"""The share of the traced encode half in which the profile shows no device
kernel, copy or set."""


def read(ctx):
    return ctx.idle_pct("encode")
