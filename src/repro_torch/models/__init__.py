"""Models of the port: the layer library, the deployed SNN CNNs, the
decoder-only LM of every family (dense, moe, ssm, hybrid, vlm) and the
encoder-decoder."""
