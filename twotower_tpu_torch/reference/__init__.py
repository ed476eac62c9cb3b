"""Plain references of the port's models, in float32 PyTorch, which the tests
hold the port against; they import nothing of the port."""
