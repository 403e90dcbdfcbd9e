"""Plain float32 references of the benchmark's configurations: plain torch,
independent of the program."""
