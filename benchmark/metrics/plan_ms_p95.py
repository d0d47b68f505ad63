"""The 95th percentile of every request's latency in the window, in ms
(host clock, from the cloud and waypoints handed over to the plan on the
host; numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    lat = [a.latency_ms for a in ctx.answers]
    return float(np.percentile(lat, 95)) if lat else None
