"""The plain reference the benchmark holds the program's outputs against;
it imports nothing of the program."""
