"""Neural-network configs, layers, activations and weight init."""
