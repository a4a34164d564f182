"""The benchmark's shared machinery: the cell's files found by name, the
card and its record, spans, the profiler's reduction, FLOP and roofline
arithmetic, traffic generation, weights from the seed, and one driver a
kind of traffic.  Nothing here names a configuration, a mix or a
per-layer metric: those are files of their own."""
