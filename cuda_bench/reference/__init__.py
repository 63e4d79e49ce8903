"""The plain float32 reference the benchmark holds the program against;
it imports nothing of the program."""
