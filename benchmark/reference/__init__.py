"""Plain references the benchmark holds the program's outputs against.
They import nothing of the program and take nothing it made."""
