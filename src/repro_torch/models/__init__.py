"""Models of the port: the layer library, the deployed SNN CNNs and the
spiking LM of the dense family."""
