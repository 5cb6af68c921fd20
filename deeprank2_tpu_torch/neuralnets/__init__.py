"""Neural-network layers and models of the port."""
