"""reader.inflate_mb_per_s: the bytes of text the C++ reader's gzip inflate
made (counter `reader.inflated_bytes`) over the seconds it spent in it
(counter `reader.inflate_s`), in MB/s, from the run logs' `counters:` lines
(portbench/spans.py).  Nothing where no job counts the inflate (a program
that predates the counters, or input that is not gzip).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.ratio(ctx, ("counters", "reader.inflated_bytes"),
                       ("counters", "reader.inflate_s"), scale=1e-6)
