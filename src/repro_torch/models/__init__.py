"""Models of the port: the layer library and the deployed SNN CNNs."""
