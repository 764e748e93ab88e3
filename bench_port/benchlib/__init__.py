"""The benchmark's general code: loading a cell by name, driving the
program, reading the trace, and the result line.  Everything that belongs
to one configuration, traffic mix, per-layer metric or reference lives in
a file of its own beside this package and is found by name."""
