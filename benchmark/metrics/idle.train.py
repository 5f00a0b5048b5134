"""idle.train: the share of the traced training steps' wall time (host
clock, synchronised at both ends) in which no operation ran on the card."""


def read(layer: dict):
    t = layer.get("trace")
    if t is None or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
