"""The share of the traced decode half in which the profile shows no device
kernel, copy or set."""


def read(ctx):
    return ctx.idle_pct("decode")
