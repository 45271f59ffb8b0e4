"""The decode transform's share of its roofline: its least time on a batch of
the cell (operations at the peak or bytes at 3.35 TB/s) over its device
time alone after the window."""


def read(ctx):
    return ctx.transform_roofline("decode")
