"""Configuration: input types, layer configs, network configs."""
