"""Device records (kernels, copies, sets) of the traced decode half per image:
the host glue's launches and copies, read from the profile."""


def read(ctx):
    return ctx.kernels_per_image("decode")
