"""idle_pct.shadow (%): the share of the traced span in which no kernel,
memcpy or memset ran on the device."""


def read(run):
    t = run.trace
    return None if t is None else t.idle_pct
