"""3D convolutional networks of the port."""
