"""The mean host us of one int8 site, the program's span ``refid.int8.site``
(resolve, weight cache, amax or group max, Q8, halo exchange, C8's launch)."""

from portbench.spans import span_mean_us


def read(run):
    return span_mean_us(run, "refid.int8.site")
