"""Model A/B forward (NCHW), the model registry and the weight bridge."""
