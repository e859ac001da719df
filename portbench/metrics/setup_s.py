"""setup_s: seconds from process start to the window's first request
(imports, kernel library, data from the seed, the index built to the
configuration's state, the warm-up of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
