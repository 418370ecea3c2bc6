"""The plain reference the benchmark judges the program by: NumPy only,
and nothing of the program."""
