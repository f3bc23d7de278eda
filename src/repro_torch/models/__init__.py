"""Model stack of the port: modules hold serving weights as buffers."""
