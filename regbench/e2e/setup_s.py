"""setup_s: seconds from the start of the process to the first timed call:
imports, loading the kernels built in the checkout, making the data on the
device and warming up the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
