"""The benchmark's own code: the catalog of cells, the measured window, the
traffic generator, the weights, the profiler's reading and the comparison
that decides ``correct``. Nothing here imports the program; the drivers
under ``drivers/`` do."""
