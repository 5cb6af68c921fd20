"""Graph neural networks of the port."""
