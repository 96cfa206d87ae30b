"""The plain float32 reference the benchmark's check compares against."""
