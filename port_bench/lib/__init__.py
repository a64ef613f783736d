"""The benchmark's shared code: the cell's files, the seeded inputs and weights, the
work count, the trace's reduction, the comparisons and the result line."""
