"""The 95th percentile of an image's latency over the measured window's
images (host arrays in, the restored image on the card, synchronised), in
ms.  The closed loop keeps the system at capacity, so the tail sits
beside the rate as a per-layer metric."""

import numpy as np


def read(run):
    if not run.window.latencies:
        return None
    return float(np.percentile(run.window.latencies, 95)) * 1e3
