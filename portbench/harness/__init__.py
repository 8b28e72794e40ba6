"""The port's benchmark harness: cells found by name in BENCHMARK.json,
traffic made from a seed, a closed loop of chunks through the program,
the trace's readers and the comparison with the plain reference."""
