"""device_idle (layer: device): the share of the traced stretch in which no
operation ran on the card, 100 - 100 x the union of the device operations'
intervals over the stretch."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
