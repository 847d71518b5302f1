"""The dense LM of the port: config, layers, and the layer-looped LM."""
